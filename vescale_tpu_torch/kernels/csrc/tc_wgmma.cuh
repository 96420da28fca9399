// Building blocks of the port's tensor-core (wgmma) kernels for Hopper
// (sm_90a): cp.async into 128-byte-swizzled shared-memory tiles, wgmma
// descriptors and the m64nNk16 products with fp32 accumulators, and the
// accumulator layout that lets a score tile, rounded to bf16 in registers,
// be the A operand of the next product.  Used by flash_fwd.cu and
// flash_bwd.cu, each a translation unit of its own: everything here has
// internal linkage.  _build.py hashes this header into both libraries'
// names, so an edit here rebuilds them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {
namespace tc {

constexpr int kThreads = 128;  // one warpgroup issues every product
constexpr int kRows = 64;  // wgmma's m64: queries (forward, dq) or keys (dkv)
constexpr float kLog2e = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- cp.async: global -> shared, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy of this thread has landed, and is visible to wgmma (the async proxy)
__device__ __forceinline__ void cp_async_drain() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers that an in-flight wgmma reads or writes: the compiler may
// not move their uses across this point, nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (K-major: the next 16 bytes of a row; MN-major: the next
// 64-column block), stride byte offset 1024 (the next group of 8 rows).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

#define VTT_F8(b)                                                                            \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),            \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define VTT_F32 VTT_F8(0), VTT_F8(8), VTT_F8(16), VTT_F8(24)
#define VTT_F64 VTT_F32, VTT_F8(32), VTT_F8(40), VTT_F8(48), VTT_F8(56)

// acc (64 x 64) (+)= A . B^T, A and B K-major descriptors
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : VTT_F32
      : "l"(a), "l"(b), "r"(scale_d));
}
// acc (64 x 64) += A . B, A bf16 fragments in registers, B an MN-major descriptor
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VTT_F32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// acc (64 x 128) += A . B, A bf16 fragments in registers, B an MN-major descriptor
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : VTT_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef VTT_F8
#undef VTT_F32
#undef VTT_F64

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128, "head_dim 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n128(d, a, b);
}

// A ROWS x D bf16 tile, 128-byte swizzled as TMA's SWIZZLE_128B lays it:
// [D / 64 column blocks][ROWS][128 bytes], the 16-byte chunk c of row r at
// slot (c ^ r) % 8 of its row.  The same bytes serve wgmma K-major (D the
// depth) and MN-major (the rows the depth), which is what lets a score
// tile's accumulator feed the next product from registers.
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c ^ r) & 7) << 4);
}

// rows r0 .. r0+ROWS-1 of a (seq, D) matrix into a swizzled tile at dst;
// rows past seq are zero-filled
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int r0, int seq, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * CH % kThreads == 0, "tile split");
#pragma unroll
  for (int it = 0; it < ROWS * CH / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / CH, c = idx % CH;
    const bool in = r0 + r < seq;
    cp_async16(dst + swizzled<ROWS>(r, c), src + (in ? (size_t)(r0 + r) * D + c * 8 : 0),
               in ? 16 : 0);
  }
}

// acc (64 x N) = A (64 x D) . B (N x D)^T over depth D: A and B swizzled
// tiles of 64 and N rows, read K-major; each k16 step is 32 bytes along a
// row, each 64-column block a new tile region
template <int N, int D>
__device__ __forceinline__ void gemm_ss(float (&acc)[N / 2], uint32_t a, uint32_t b) {
  static_assert(N == 64, "score tiles are 64 wide");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss_n64(acc, desc(a + (kk >> 2) * (kRows * 128) + (kk & 3) * 32, 16),
                 desc(b + (kk >> 2) * (N * 128) + (kk & 3) * 32, 16), kk > 0);
  }
}

// acc (64 x D) += A (64 x K) . B (K x D): A bf16 fragments in registers, B
// a swizzled tile of K rows read MN-major (transposed); each k16 step is
// 16 rows, the second 64-column block one tile region on
template <int K, int D>
__device__ __forceinline__ void gemm_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<D>(acc, a[kk], desc(b + kk * 16 * 128, K * 128));
}

// The m64nNk16 accumulator: element i of thread (warp w, lane l) is row
// w*16 + l/4 + 8*((i/2)%2), column (i/4)*8 + 2*(l%4) + i%2.  Those are the
// rows and columns of the register A fragment of the next product, so a
// score tile becomes its A operand by rounding pairs to bf16 in place.
template <int N>
__device__ __forceinline__ void to_fragments(const float (&acc)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 h = __floats2bfloat162_rn(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1]);
      a[kk][e] = *reinterpret_cast<uint32_t*>(&h);
    }
}

// rows row0 + w*16 + l/4 (+8) of a 64 x D accumulator, cast to bf16, into
// a (seq, D) matrix; rows past seq are not written
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* dst, int row0, int seq,
                                           int tid) {
  const int r = row0 + (tid / 32) * 16 + (tid % 32) / 4;
  const int c = 2 * (tid % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= seq) continue;
    bf16* row = dst + (size_t)(r + 8 * h) * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

}  // namespace tc
}  // namespace
