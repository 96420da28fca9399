// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vescale_tpu/kernels/flash_attention.py::
// _fwd_kernel (resident K/V) and ::_fwd_kernel_stream (streamed K/V), both
// launched by ::_flash_fwd_pallas.  The TPU needed two variants for its VMEM
// budget; on Hopper one kernel streams K/V tiles through shared memory at
// any T.
//
// Computes, per (b*h) row and query position, causal or full softmax
// attention with an online softmax in fp32: q is scaled before Q.K^T, K, V
// and P are used in fp32, masked scores are -1e30, l = 0 is guarded to 1,
// and lse = m + log(l).  Layout: q (B*H, T, D); k, v (B*KV, T, D), q row b
// reading kv row (b / H) * KV + (b % H) / (H / KV), so GQA never repeats
// K/V.  o (B*H, T, D) in q's dtype, lse (B*H, T) fp32.  Any T: keys and
// queries past T are masked.  D is 64 or 128; fp32 or bf16 inputs.
//
// Design.  One CTA of 128 threads per (64-query block, b*h); it loops over
// 32-key blocks up to the causal diagonal.  The scaled Q tile stays in
// shared memory for the whole loop; each K/V tile is loaded once (converted
// to fp32) and used by all 64 queries.  Thread (ty, tx) owns query rows
// ty*4 .. ty*4+3, so the row state (m, l) and the output rows are thread-
// local; the 8 threads of a row reduce max and sum with shuffles.  Q, K and
// P are kept transposed in shared memory, so each step of a dot reads four
// rows (or keys) with one 16-byte load: two loads feed 16 FMAs in Q.K^T,
// five feed 64 in P.V.  Tiles come from global memory in 16-byte loads, all
// of a thread's issued before it stores any.  No atomics: the result is the
// same from run to run.
//
// Bound: 2 * T^2 * H * D FLOPs for causal attention (4 * T^2 * H * D when
// full), against the dense bf16 tensor-core peak, or the bytes of q, k, v
// and o against memory bandwidth.  This first kernel does its dots in fp32
// on the CUDA cores, as the TPU reference upcasts K, V and P to fp32, so
// it cannot approach the tensor-core bound.  A wgmma kernel with bf16 P,
// fed by TMA, is the later design; it would round P to bf16, a departure
// from the reference that its parity bound would have to state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;       // queries per CTA
constexpr int BK = 32;       // keys per tile
constexpr int RQ = BQ / 16;  // query rows per thread: ty*4 .. ty*4+3
constexpr int CK = BK / 8;   // key columns per thread: tx*4 .. tx*4+3
constexpr int QP = BQ + 4;   // row of the transposed Q and P tiles (16-byte aligned, banks spread)
constexpr int KP = BK + 4;   // row of the transposed K tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of global memory: 4 floats or 8 bf16 values, loaded raw and
// converted to fp32 later.  The wrapper checks that every tensor starts on a
// 16-byte boundary; D is a multiple of 8, so every row does too.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void to_float(const uint4& raw, float (&out)[N]) {
    const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = f[e];
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void to_float(const uint4& raw, float (&out)[N]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < N / 2; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Loading a (ROWS, D) tile of a (seq, D) matrix from row r0: thread chunk
// `it` covers 16 bytes.  For the transposed tile, consecutive threads take
// consecutive rows, so the transposed stores dst[c * LD + r] hit distinct
// banks; for the row-major one, consecutive 16-byte pieces.  Rows past seq
// read row seq-1 and store zero.
template <typename T, int D, int ROWS>
struct Tile {
  static constexpr int NV = Vec<T>::N;
  static constexpr int ITERS = ROWS * D / NV / kThreads;
  static_assert(ITERS * kThreads * NV == ROWS * D, "tile split");

  __device__ __forceinline__ static void load_t(const T* src, int r0, int seq, int tid,
                                                uint4 (&raw)[ITERS]) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * kThreads;
      raw[it] = load16(src + (size_t)min(r0 + idx % ROWS, seq - 1) * D + (idx / ROWS) * NV);
    }
  }
  template <int LD>
  __device__ __forceinline__ static void store_t(const uint4 (&raw)[ITERS], int r0, int seq,
                                                 float mul, float* dst, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx % ROWS;
      const int c = (idx / ROWS) * NV;
      const bool in = r0 + r < seq;
      float val[NV];
      Vec<T>::to_float(raw[it], val);
#pragma unroll
      for (int e = 0; e < NV; ++e) dst[(c + e) * LD + r] = in ? val[e] * mul : 0.f;
    }
  }
  __device__ __forceinline__ static void load(const T* src, int r0, int seq, int tid,
                                              uint4 (&raw)[ITERS]) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int off = (tid + it * kThreads) * NV;
      raw[it] = load16(src + (size_t)min(r0 + off / D, seq - 1) * D + off % D);
    }
  }
  __device__ __forceinline__ static void store(const uint4 (&raw)[ITERS], int r0, int seq,
                                               float* dst, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int off = (tid + it * kThreads) * NV;
      const bool in = r0 + off / D < seq;
      float val[NV];
      Vec<T>::to_float(raw[it], val);
#pragma unroll
      for (int e = 0; e < NV; e += 4) {
        *reinterpret_cast<float4*>(&dst[off + e]) =
            in ? make_float4(val[e], val[e + 1], val[e + 2], val[e + 3])
               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
};

__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

template <int D>
constexpr int smem_bytes() {
  return (D * QP + D * KP + BK * D + BK * QP) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int seq, int H, int KV,
    float scale, int causal) {
  constexpr int CD = D / 8;  // output columns per thread: m*32 + tx*4 + e
  static_assert(RQ == 4 && CK == 4 && D % 32 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;            // [D][QP]  scaled Q, transposed
  float* kT = qT + D * QP;     // [D][KP]  K tile, transposed
  float* v_s = kT + D * KP;    // [BK][D]  V tile
  float* pT = v_s + BK * D;    // [BK][QP] P tile, transposed

  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int rep = H / KV;
  const int kvrow = (bh / H) * KV + (bh % H) / rep;
  const T* qp = q + (size_t)bh * seq * D;
  const T* kp = k + (size_t)kvrow * seq * D;
  const T* vp = v + (size_t)kvrow * seq * D;

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;

  {
    using QTile = Tile<T, D, BQ>;
    uint4 raw[QTile::ITERS];
    QTile::load_t(qp, q0, seq, tid, raw);
    QTile::template store_t<QP>(raw, q0, seq, scale, qT, tid);
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int nkb = (seq + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tile is consumed (and qT is written)
    {
      using KVTile = Tile<T, D, BK>;
      uint4 kraw[KVTile::ITERS], vraw[KVTile::ITERS];
      KVTile::load_t(kp, k0, seq, tid, kraw);  // every load issued before
      KVTile::load(vp, k0, seq, tid, vraw);    // the first store
      KVTile::template store_t<KP>(kraw, k0, seq, 1.f, kT, tid);
      KVTile::store(vraw, k0, seq, v_s, tid);
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[RQ], b[CK];
      load4(&qT[c * QP + ty * RQ], a);
      load4(&kT[c * KP + tx * CK], b);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] += a[i] * b[j];
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qr = q0 + ty * RQ + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kc = k0 + tx * CK + j;
        const bool keep = kc < seq && (!causal || kc <= qr);
        s[i][j] = keep ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        pT[(tx * CK + j) * QP + ty * RQ + i] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[RQ];
      load4(&pT[kk * QP + ty * RQ], pa);
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm) {
        float vv[4];
        load4(&v_s[kk * D + mm * 32 + tx * 4], vv);
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][mm * 4 + e] += pa[i] * vv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qr = q0 + ty * RQ + i;
    if (qr < seq) {
      const float ls = l[i] == 0.f ? 1.f : l[i];
      T* orow = o + ((size_t)bh * seq + qr) * D;
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + mm * 32 + tx * 4 + e, acc[i][mm * 4 + e] / ls);
      if (tx == 0) lse[(size_t)bh * seq + qr] = m[i] + logf(ls);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int BH, int seq, int H, int KV, float scale, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  is_bf16 selects bf16
// (1) or fp32 (0) for q, k, v and o.
extern "C" int vtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int seq, int D,
                             int H, int KV, float scale, int causal,
                             int is_bf16, void* stream) {
  if (BH <= 0 || seq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || BH % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st)
                   : launch<float, 64>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st)
                   : launch<float, 128>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
