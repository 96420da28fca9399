// Fused adamw_lowmem moment update for Hopper (sm_90a), over every leaf of
// a model in one multi-tensor launch.
//
// Replaces the Pallas TPU kernel vescale_tpu/kernels/fused_adamw.py::
// _adamw_kernel (launched per leaf by ::_fused_local).  Per element, in fp32
// and in the reference chain's order (vescale_tpu/parallel/optimizer.py::
// scale_by_adam_lowmem):
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * (g * g)
//   u  = (m' / c1) / (sqrt(v' / c2) + eps)
// u is written in g's dtype, m' and v' in the state dtype.  c1 and c2 are the
// caller's fp32 bias corrections; b1, 1 - b1, b2, 1 - b2 and eps arrive as the
// fp32 values the reference multiplies by.  A NaN in g poisons u, m' and v'
// at exactly that element.
//
// Bitwise moments.  This file is compiled with --fmad=false: nvcc would
// otherwise contract b1 * m + (1 - b1) * g into an FMA, which rounds once
// where the reference rounds twice and flips the last bit of m' (a 1-ulp
// divergence of exactly this kind, from mul+add contraction, was measured
// on the JAX side).  sqrtf and '/' stay IEEE-rounded (nvcc's defaults
// -prec-sqrt=true -prec-div=true), as in the reference.
//
// Design.  The wrapper passes a device table of leaves (pointers, size and
// the first block of each); block i finds its leaf by binary search over
// the first-block column and works one chunk of it (a multiple of 4
// elements; the wrapper uses 8192).  Each thread handles 4 consecutive
// elements with one vector load per operand (16 bytes of fp32, 8 of bf16;
// the wrapper checks 16-byte alignment of every leaf) and falls back to
// scalar accesses only at a leaf's ragged end, so odd and tiny leaves need
// no padding copy.  Zero-size leaves are
// left out of the table.  Bound: bytes.  Each element reads g, m, v and
// writes u, m', v' once (16 bytes with fp32 g and u, bf16 state), against
// memory bandwidth; the arithmetic is a few operations per element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;

struct Leaf {
  const void* g;
  const void* m;
  const void* v;
  void* u;
  void* mo;
  void* vo;
  long long n;       // elements
  long long block0;  // first block of this leaf
};

struct Coef {
  float b1, omb1, b2, omb2, c1, c2, eps;
};

template <typename T>
struct V4;
template <>
struct V4<float> {
  __device__ __forceinline__ static void load(const float* p, float (&o)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
  __device__ __forceinline__ static float get(const float* p) { return *p; }
  __device__ __forceinline__ static void put(float* p, float x) { *p = x; }
};
template <>
struct V4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&o)[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    o[0] = a.x;
    o[1] = a.y;
    o[2] = b.x;
    o[3] = b.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&o)[4]) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(o[0], o[1]);
    h[1] = __floats2bfloat162_rn(o[2], o[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
  __device__ __forceinline__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ __forceinline__ static void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
};

__device__ __forceinline__ void chain(const Coef& k, float g, float m, float v, float& u,
                                      float& mo, float& vo) {
  mo = k.b1 * m + k.omb1 * g;
  vo = k.b2 * v + k.omb2 * (g * g);
  u = (mo / k.c1) / (sqrtf(vo / k.c2) + k.eps);
}

template <typename G, typename S>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const Leaf* __restrict__ leaves,
                                                         int n_leaves, long long chunk,
                                                         Coef coef) {
  const long long b = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {  // the last leaf whose first block is <= b
    const int mid = (lo + hi + 1) / 2;
    if (leaves[mid].block0 <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf L = leaves[lo];
  const G* g = static_cast<const G*>(L.g);
  const S* m = static_cast<const S*>(L.m);
  const S* v = static_cast<const S*>(L.v);
  G* u = static_cast<G*>(L.u);
  S* mo = static_cast<S*>(L.mo);
  S* vo = static_cast<S*>(L.vo);
  const long long start = (b - L.block0) * chunk;
  const long long end = min(start + chunk, L.n);
  for (long long i = start + threadIdx.x * kVec; i < end; i += kThreads * kVec) {
    if (i + kVec <= end) {
      float gg[4], mm[4], vv[4], uu[4], m2[4], v2[4];
      V4<G>::load(g + i, gg);
      V4<S>::load(m + i, mm);
      V4<S>::load(v + i, vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) chain(coef, gg[e], mm[e], vv[e], uu[e], m2[e], v2[e]);
      V4<G>::store(u + i, uu);
      V4<S>::store(mo + i, m2);
      V4<S>::store(vo + i, v2);
    } else {
      for (long long j = i; j < end; ++j) {
        float uu, m2, v2;
        chain(coef, V4<G>::get(g + j), V4<S>::get(m + j), V4<S>::get(v + j), uu, m2, v2);
        V4<G>::put(u + j, uu);
        V4<S>::put(mo + j, m2);
        V4<S>::put(vo + j, v2);
      }
    }
  }
}

template <typename G, typename S>
int launch(const Leaf* leaves, int n_leaves, long long n_blocks, long long chunk,
           const Coef& coef, cudaStream_t stream) {
  adamw_kernel<G, S><<<static_cast<unsigned>(n_blocks), kThreads, 0, stream>>>(
      leaves, n_leaves, chunk, coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  `table` is a device
// array of n_leaves records of 8 eight-byte words each: g, m, v, u, m', v'
// pointers, the element count and the first block, ordered by first block;
// n_blocks is the total and `chunk` the elements of each block.  g_bf16 /
// state_bf16 select bf16 (1) or fp32 (0) for g and u, and for m, v, m', v'.
extern "C" int vtt_fused_adamw(const void* table, int n_leaves, long long n_blocks,
                               long long chunk, float b1, float omb1, float b2, float omb2,
                               float c1, float c2, float eps, int g_bf16, int state_bf16,
                               void* stream) {
  static_assert(sizeof(Leaf) == 64, "table record layout");
  if (n_leaves <= 0 || n_blocks <= 0 || n_blocks > 0x7fffffffLL || chunk <= 0 || chunk % kVec)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaf* leaves = static_cast<const Leaf*>(table);
  const Coef coef{b1, omb1, b2, omb2, c1, c2, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    return state_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(leaves, n_leaves, n_blocks, chunk, coef, st)
                      : launch<__nv_bfloat16, float>(leaves, n_leaves, n_blocks, chunk, coef, st);
  }
  return state_bf16 ? launch<float, __nv_bfloat16>(leaves, n_leaves, n_blocks, chunk, coef, st)
                    : launch<float, float>(leaves, n_leaves, n_blocks, chunk, coef, st);
}
