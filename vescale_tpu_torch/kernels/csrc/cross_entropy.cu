// Fused cross entropy over the vocab dim for Hopper (sm_90a): the forward's
// three row sums in one read of the logits, and the backward's gradient in
// one elementwise pass.
//
// Replaces the Pallas TPU kernels vescale_tpu/kernels/cross_entropy.py::
// _xent_fwd_kernel (launched by ::_fwd_call) and ::_xent_bwd_kernel
// (launched by ::_bwd_call).  Per row r of lg (N, Vs), with gmax[r] the
// caller's row max and idx[r] the gold column:
//   forward   sumexp[r] = sum_c exp(lg[r,c] - gmax[r])
//             picked[r] = sum_c (c == idx[r] ? lg[r,c] : 0)
//             sumlg[r]  = sum_c lg[r,c]
//   backward  dlg[r,c]  = gse[r] * exp(lg[r,c] - gmax[r])
//                         + (c == idx[r] ? gpk[r] : 0) + gsl[r]
// in fp32, in that operation order.  Every add, subtract and multiply is an
// explicitly rounded intrinsic (__fadd_rn, __fsub_rn, __fmul_rn), which
// nvcc never contracts into an FMA, so the backward rounds where the
// reference's jnp ops round.  lg is fp32 or bf16; bf16 is upcast in
// registers (exact), and dlg is written in lg's dtype, rounded once from
// fp32 (round to nearest even, as the reference's astype is).
//
// The pick is exact: a column is compared to idx as a 64-bit integer, so an
// index outside [0, Vs) never hits and its row's picked is 0.  A NaN in a
// row makes its sumexp and sumlg NaN, as the reference's sums are.
//
// Design.  Forward: one CTA of 512 threads per row.  Each thread strides
// the row with 16-byte loads (4 fp32 or, for bf16, 8-byte loads of 4
// values) and keeps its three fp32 partial sums in registers; the 512
// partials combine in a fixed tree (warp shuffles, then the 16 warp sums
// in shared memory, summed by warp 0).  No atomics and no split that
// depends on the run: two launches are bitwise equal.  Backward: a CTA
// covers 4096 columns of one row (256 threads x 4 vectors of 4), rows
// along grid y.  Rows whose Vs is not a multiple of 4, or whose base is
// not aligned, take scalar accesses (the wrapper decides); any N >= 1 and
// Vs >= 1 run, masked, with no fallback.  Offsets are 64-bit: N * Vs
// elements of fp32 exceed 2^31 bytes at the GPT-2 shape (12,288 x 50,304).
//
// Bound: bytes.  The forward reads each logit once (N * Vs * 4 bytes in
// fp32); the backward reads each logit and writes each gradient once.  The
// arithmetic is one exp and a few adds per element, far below the card's
// rate, so both kernels are judged against memory bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVec = 4;
constexpr int kFwdThreads = 512;
constexpr int kBwdThreads = 256;
constexpr int kBwdVecsPerThread = 4;
constexpr int kBwdCols = kBwdThreads * kVec * kBwdVecsPerThread;  // columns per CTA
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

__device__ __forceinline__ void load4(const float* p, float (&o)[kVec]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[kVec]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&o)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[kVec]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(o[0], o[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(o[2], o[3]);
  uint2 v;
  v.x = *reinterpret_cast<unsigned int*>(&a);
  v.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = v;
}

struct Sums {
  float se, pk, sl;

  __device__ __forceinline__ void visit(long long col, long long target, float x, float m) {
    se = __fadd_rn(se, expf(__fsub_rn(x, m)));
    if (col == target) pk = __fadd_rn(pk, x);
    sl = __fadd_rn(sl, x);
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, s));
  return x;  // lane 0 holds the warp's sum, in a fixed order
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    xent_fwd_kernel(const T* __restrict__ lg, const long long* __restrict__ idx,
                    const float* __restrict__ gmax, float* __restrict__ se_out,
                    float* __restrict__ pk_out, float* __restrict__ sl_out, int vs, int vec) {
  __shared__ float warp_part[3][kFwdThreads / 32];
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* r = lg + row * (long long)vs;
  const float m = gmax[row];
  const long long target = idx[row];
  Sums acc{0.0f, 0.0f, 0.0f};
  if (vec) {
    for (int c = tid * kVec; c < vs; c += kFwdThreads * kVec) {
      float x[kVec];
      load4(r + c, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc.visit(c + j, target, x[j], m);
    }
  } else {
    for (int c = tid; c < vs; c += kFwdThreads) acc.visit(c, target, to_f32(r[c]), m);
  }
  const float se = warp_sum(acc.se), pk = warp_sum(acc.pk), sl = warp_sum(acc.sl);
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    warp_part[0][warp] = se;
    warp_part[1][warp] = pk;
    warp_part[2][warp] = sl;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kFwdThreads / 32;
    const float a = lane < kWarps ? warp_part[0][lane] : 0.0f;
    const float b = lane < kWarps ? warp_part[1][lane] : 0.0f;
    const float c = lane < kWarps ? warp_part[2][lane] : 0.0f;
    const float sa = warp_sum(a), sb = warp_sum(b), sc = warp_sum(c);
    if (lane == 0) {
      se_out[row] = sa;
      pk_out[row] = sb;
      sl_out[row] = sc;
    }
  }
}

__device__ __forceinline__ float grad_at(float x, long long col, long long target, float m,
                                         float gse, float gpk, float gsl) {
  float d = __fmul_rn(gse, expf(__fsub_rn(x, m)));
  d = __fadd_rn(d, col == target ? gpk : 0.0f);
  return __fadd_rn(d, gsl);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    xent_bwd_kernel(const T* __restrict__ lg, const long long* __restrict__ idx,
                    const float* __restrict__ gmax, const float* __restrict__ gse,
                    const float* __restrict__ gpk, const float* __restrict__ gsl,
                    T* __restrict__ dlg, long long n_rows, int vs, int vec) {
  const int base = blockIdx.x * kBwdCols;
  for (long long row = blockIdx.y; row < n_rows; row += gridDim.y) {
    const long long off = row * (long long)vs;
    const float m = gmax[row], a = gse[row], p = gpk[row], s = gsl[row];
    const long long target = idx[row];
    if (vec) {
#pragma unroll
      for (int j = 0; j < kBwdVecsPerThread; ++j) {
        const int c = base + (j * kBwdThreads + threadIdx.x) * kVec;
        if (c >= vs) break;
        float x[kVec];
        load4(lg + off + c, x);
#pragma unroll
        for (int e = 0; e < kVec; ++e) x[e] = grad_at(x[e], c + e, target, m, a, p, s);
        store4(dlg + off + c, x);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec * kBwdVecsPerThread; ++j) {
        const int c = base + j * kBwdThreads + threadIdx.x;
        if (c >= vs) break;
        from_f32(grad_at(to_f32(lg[off + c]), c, target, m, a, p, s), dlg + off + c);
      }
    }
  }
}

template <typename T>
int launch_fwd(const void* lg, const void* idx, const void* gmax, void* se, void* pk, void* sl,
               long long n_rows, int vs, int vec, cudaStream_t stream) {
  xent_fwd_kernel<T><<<(unsigned int)n_rows, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(lg), static_cast<const long long*>(idx),
      static_cast<const float*>(gmax), static_cast<float*>(se), static_cast<float*>(pk),
      static_cast<float*>(sl), vs, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* lg, const void* idx, const void* gmax, const void* gse,
               const void* gpk, const void* gsl, void* dlg, long long n_rows, int vs, int vec,
               cudaStream_t stream) {
  const dim3 grid((unsigned int)((vs + kBwdCols - 1) / kBwdCols),
                  (unsigned int)(n_rows < kMaxGridY ? n_rows : kMaxGridY));
  xent_bwd_kernel<T><<<grid, kBwdThreads, 0, stream>>>(
      static_cast<const T*>(lg), static_cast<const long long*>(idx),
      static_cast<const float*>(gmax), static_cast<const float*>(gse),
      static_cast<const float*>(gpk), static_cast<const float*>(gsl), static_cast<T*>(dlg),
      n_rows, vs, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// lg (n_rows, vs) fp32 or bf16 (is_bf16), contiguous; idx (n_rows,) int64;
// gmax and the three outputs (n_rows,) fp32.  vec = 1 only when vs is a
// multiple of 4 and lg is 16-byte aligned.  1 <= n_rows < 2^31.  Returns
// the launch's cudaError_t.
extern "C" int vtt_xent_fwd(const void* lg, const void* idx, const void* gmax, void* se, void* pk,
                            void* sl, long long n_rows, int vs, int is_bf16, int vec,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_fwd<__nv_bfloat16>(lg, idx, gmax, se, pk, sl, n_rows, vs, vec, st);
  return launch_fwd<float>(lg, idx, gmax, se, pk, sl, n_rows, vs, vec, st);
}

// As above, plus the cotangents gse, gpk, gsl (n_rows,) fp32 and dlg
// (n_rows, vs) in lg's dtype.  vec = 1 also needs dlg 16-byte aligned.
extern "C" int vtt_xent_bwd(const void* lg, const void* idx, const void* gmax, const void* gse,
                            const void* gpk, const void* gsl, void* dlg, long long n_rows, int vs,
                            int is_bf16, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_bwd<__nv_bfloat16>(lg, idx, gmax, gse, gpk, gsl, dlg, n_rows, vs, vec, st);
  return launch_bwd<float>(lg, idx, gmax, gse, gpk, gsl, dlg, n_rows, vs, vec, st);
}
