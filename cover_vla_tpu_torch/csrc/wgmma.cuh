// Hopper (sm_90a) building blocks of the warpgroup attention kernels:
// shared-memory matrix descriptors, the asynchronous warpgroup products
// (wgmma.mma_async) with their fences, and asynchronous global -> shared
// copies (cp.async). Used by flash_wgmma.cuh and decode_wgmma.cuh.
//
// Shared-memory tile layout ("chunk-column-major"), one layout for every
// operand. A tile of up to 64 rows by C columns of bf16 is stored as
// 16-byte chunks of 8 columns: chunk (row r, column chunk c) lies at byte
// c * CHUNK + r * 16, with CHUNK = 64 * 16 + 16. Eight consecutive rows of
// one column chunk are 128 contiguous bytes, which is exactly one 8 x 8
// core matrix of wgmma's no-swizzle descriptor mode, so
//   - as an operand whose reduction dimension runs along the columns
//     (Q and K in S = Q K^T; "K-major"): core matrices 8 rows apart are
//     128 bytes apart (stride byte offset), the two column chunks of one
//     depth-16 step are CHUNK bytes apart (leading byte offset), and depth
//     step kk starts 2 * kk * CHUNK bytes into the tile;
//   - as a B operand whose reduction dimension runs along the rows
//     (V in O = P V; "MN-major", the descriptor's transpose-B form): the
//     two groups of 8 rows of one depth-16 step are 128 bytes apart
//     (leading byte offset), column chunks CHUNK bytes apart (stride byte
//     offset), and depth step kc starts kc * 256 bytes into the tile.
// Copies write 16 bytes per thread, consecutive threads on the consecutive
// chunks of one row: the 16 bytes over 64 * 16 in CHUNK put them in
// different banks. The layout takes any head dim that is a multiple of 8
// padded to a multiple of 16 (72 -> 80) as it takes 64 or 256, which a
// 128-byte swizzle row would not.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// no-swizzle matrix descriptor: start address, leading and stride byte
// offsets, all in units of 16 bytes; layout type (bits 62-63) 0
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr,
                                               uint32_t leading_bytes,
                                               uint32_t stride_bytes) {
  return uint64_t((smem_addr & 0x3ffffu) >> 4) |
         (uint64_t(leading_bytes >> 4) << 16) |
         (uint64_t(stride_bytes >> 4) << 32);
}

// 128-byte-swizzle matrix descriptor (layout type 1 in bits 62-63), the
// layout that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B: rows of 128
// bytes (64 bf16), the 16-byte chunks of row r permuted by r mod 8, eight
// rows (1024 bytes, aligned) one swizzle atom. Used by decode_wgmma.cuh.
//   K-major (Q and K in S = Q K^T): stride byte offset 1024 between groups
//   of 8 rows, the leading byte offset unused (16); depth step kk of 16
//   columns starts 32 * (kk mod 4) bytes into its 64-column slab.
//   MN-major (V in O = P V, transposed-B form): 1024 between groups of 8
//   keys along the reduction, the leading byte offset the distance to the
//   next 64-column slab.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t smem_addr,
                                                     uint32_t leading_bytes,
                                                     uint32_t stride_bytes) {
  return wgmma_desc(smem_addr, leading_bytes, stride_bytes) | (1ull << 62);
}

// orders the warpgroup's register and shared-memory accesses before the
// products that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving uses of an accumulator across the
// asynchronous products' issue and wait
template <int N>
__device__ __forceinline__ void wgmma_pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// makes shared memory written through the generic proxy (cp.async, plain
// stores) visible to the asynchronous proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte global -> shared copy that does not pass through registers;
// with valid == false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// the same for 8 bytes
__device__ __forceinline__ void cp_async_8(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x for x <= 0 (and -inf -> 0), one special-function instruction,
// relative error 2^-22
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[64 x 64] (+)= A[64 x 16] * B[64 x 16]^T, both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a_desc,
                                             uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] * B[32 x 16]^T, both operands in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t a_desc,
                                             uint64_t b_desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] * B[16 x 16]: A from registers, B in shared
// memory with the N dimension contiguous (transposed-B descriptor)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32]: A from registers, B in shared
// memory with the N dimension contiguous (transposed-B descriptor)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers, B in shared
// memory with the N dimension contiguous (transposed-B descriptor)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// O[64 x N] += P[64 x 16] * V[16 x N] for a compile-time N that is a
// multiple of 16: products of width 64 over accumulator slices, then one of
// width 32 and one of width 16 for the rest. `col_chunk_bytes` is the
// distance between V's 16-byte column chunks (CHUNK above).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t* a, uint32_t v_addr,
                                         uint32_t col_chunk_bytes) {
  static_assert(N % 16 == 0 && N <= 256, "accumulator width");
  constexpr int N64 = N / 64, REST = N % 64;
#pragma unroll
  for (int i = 0; i < N64; ++i)
    wgmma_rs_n64(d + 32 * i, a,
                 wgmma_desc(v_addr + i * 8 * col_chunk_bytes, 128,
                            col_chunk_bytes));
  if constexpr (REST >= 32)
    wgmma_rs_n32(d + 32 * N64, a,
                 wgmma_desc(v_addr + N64 * 8 * col_chunk_bytes, 128,
                            col_chunk_bytes));
  if constexpr (REST % 32 == 16)
    wgmma_rs_n16(d + 32 * N64 + (REST >= 32 ? 16 : 0), a,
                 wgmma_desc(v_addr + (N64 * 8 + (REST >= 32 ? 4 : 0)) *
                                         col_chunk_bytes,
                            128, col_chunk_bytes));
}

}  // namespace
