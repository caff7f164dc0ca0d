// Warpgroup building blocks of the port's Hopper (sm_90a) kernels
// (conv3x3.cu's streamed bf16 kernel): the warpgroup matrix product wgmma
// with A from registers and B from shared memory by descriptor, its fence,
// commit and wait; the shared-memory descriptor of B's canonical layout;
// TMA tensor copies into shared memory; mbarriers (init, arrive, the
// arrival that expects a TMA copy's bytes, parity wait); the register
// reallocation between a producer warpgroup and the consumer warpgroups.
//
// wgmma m64n128k16 (f32 += bf16 x bf16): four warps (a warpgroup, warp w
// of it rows 16w .. 16w + 15) start one asynchronous 64 x 128 x 16 product.
//  * A, 64 x 16 from registers: warp by warp the A fragment of mma.sync
//    m16n8k16 (mma_bf16.cuh), so an ldmatrix x4 of the warp's 16 rows gives
//    it; each lane may address its own row.
//  * B, 16 x 128 from shared memory, MN-major (a k row's 128 values
//    contiguous: the transpose bit), in the canonical 128-byte-swizzled
//    layout: per 64-column half, k row r at byte 128 r of the half, its
//    16-byte chunk j at position j ^ (r & 7), the half 1024-byte aligned;
//    the two halves LBO bytes apart, and the 8-row groups SBO = 1024 apart.
//    This is the layout TMA's 128-byte swizzle writes; mma_bf16.cuh's swz
//    is another.
//  * D, 64 x 128 f32 in 64 registers a thread: d[4 i + e] is row 16 w + g
//    + 8 (e >> 1), column 8 i + 2 t + (e & 1) (g = lane / 4, t = lane % 4),
//    mma.sync's accumulator layout over 16 n8 tiles.
// The product runs while the warps go on: registers it reads or writes may
// be touched again only after wgmma_wait has seen it done, and the
// compiler is held to that by `fence_operand` (it does not know the asm
// writes D late). The tensor core truncates its sum as mma.sync's does
// (mma_bf16.cuh's header): a caller keeps chains short and adds them in f32.

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"  // smem_u32

namespace {

// the descriptor of a 128-byte-swizzled MN-major B operand at shared
// address addr (1024-byte aligned row groups; header); lbo: bytes between
// the 64-column halves, sbo: bytes between 8-row groups
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// orders the warpgroup's register writes before the wgmma that reads them
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the compiler may not move reads or writes of r across this point
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d (+)= a . B: d = a . B where scale_d is 0, else d += a . B; a the A
// fragment (4 registers, mma.sync's), desc B's descriptor (sw128_desc)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// the barriers' initialisation made visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival on bar that also expects `bytes` more to land (TMA copies
// completing on it) before its phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------------ TMA
//
// The box of a tensor map (tm: the address of a __grid_constant__ kernel
// parameter) at element coordinates c0 (innermost) .. into shared dst, its
// bytes completing on bar; elements outside the tensor (negative
// coordinates too) are written as zeros. The tensor map's swizzle places a
// box row's 16-byte chunks by the XOR of shared-address bits, so dst is
// aligned to the swizzle's period (128-byte rows: 1024 bytes).

__device__ __forceinline__ void tma_load_3d(void* dst, const void* tm, int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(tm), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tm, int c0, int c1, int c2,
                                            int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(tm), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// a warpgroup's registers a thread: the producer gives, the consumers take
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace
