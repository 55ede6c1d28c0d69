// Hopper (sm_90a) building blocks shared by the port's kernels: cp.async
// copies, the async-proxy fence, wgmma operand layout and descriptors, and
// the exact int8 -> bf16 conversion. Included by qmm.cu (K1) and
// paged_attention.cu (K3); ops/_build.py hashes this header with each
// source, so an edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with live false nothing is read and the
// destination is zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's shared-memory writes, made visible to the tensor cores'
// reads (wgmma reads shared memory through the async proxy)
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- wgmma (sm_90a) ---
// Operands in shared memory are stored as core matrices of 8 rows x 16
// bytes (128 contiguous bytes), without swizzle, core matrices ordered
// row-group major: element (r, c) of a [rows][W] bf16 tile is at
// core_off<W>(r, c). A descriptor gives the start address and the byte
// distances between core matrices along K (lbo) and along M or N (sbo).
// A K-major operand ([M][K], K contiguous) takes lbo = 128, sbo = K * 16;
// an MN-major ("transposed") B operand ([K][N], N contiguous) takes
// lbo = N * 16, sbo = 128.
template <int W>
__device__ __forceinline__ int core_off(int r, int c) {
  return ((r >> 3) * (W / 8) + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ uint64_t wg_desc(const void* p, int lbo, int sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_commit_and_wait() {
  wg_commit();
  wg_wait<0>();
}

// 4 int8 in one word -> 4 bf16 in two words, exactly and on the full-rate
// integer and f32 pipes (not the quarter-rate conversion unit): each byte,
// biased to unsigned, becomes the low mantissa bits of 2^23, the bias is
// subtracted in f32, and the upper half of each f32 (an integer of at
// most 8 significant bits) is its bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  constexpr uint32_t MAGIC = 0x4b000000u;  // 2^23
  constexpr float BIAS = 8388736.0f;       // 2^23 + 128
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, MAGIC, 0x7540 | i)) - BIAS;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// 16 int8 -> 16 bf16 (two 16-byte words), exactly
__device__ __forceinline__ void i8x16_to_bf16(const uint4& raw, uint4& a,
                                              uint4& b) {
  i8x4_to_bf16(raw.x, a.x, a.y);
  i8x4_to_bf16(raw.y, a.z, a.w);
  i8x4_to_bf16(raw.z, b.x, b.y);
  i8x4_to_bf16(raw.w, b.z, b.w);
}

}  // namespace sm90
