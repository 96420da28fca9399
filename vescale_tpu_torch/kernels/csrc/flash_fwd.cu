// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels vescale_tpu/kernels/flash_attention.py::
// _fwd_kernel (resident K/V) and ::_fwd_kernel_stream (streamed K/V), both
// launched by ::_flash_fwd_pallas.  The TPU needed two variants for its VMEM
// budget; on Hopper one kernel streams K/V tiles through shared memory at
// any T.
//
// Computes, per (b*h) row and query position, causal or full softmax
// attention with an online softmax in fp32: masked scores are -1e30 and
// their probability 0 after the exp, l = 0 is guarded to 1, and lse =
// m + log(l) in natural-log units.  Layout: q (B*H, T, D); k, v (B*KV, T,
// D), q row b reading kv row (b / H) * KV + (b % H) / (H / KV), so GQA
// never repeats K/V.  o (B*H, T, D) in q's dtype, lse (B*H, T) fp32.  Any T: keys and
// queries past T are masked.  D is 64 or 128.  No atomics and no split of
// a row across CTAs, so the result is bitwise the same from run to run.
//
// bf16 inputs: a tensor-core kernel (tc::flash_fwd_kernel).  One warpgroup
// (128 threads) a CTA over 64 query rows (wgmma's m64), one CTA per
// (64-query block, b*h), the blocks with the longest causal rows launched
// first.  The Q tile is loaded once; K/V tiles of 64 keys stream through a
// two-stage cp.async ring (rows past T zero-filled) up to the causal
// diagonal.  Per tile: S = Q K^T by wgmma with both operands read K-major
// from 128-byte-swizzled shared memory (tc_wgmma.cuh); mask, row max across
// the four lanes that hold a row, P = exp2(s * scale * log2e - m * scale *
// log2e) (one FMA) in fp32 registers, O and l rescaled by alpha =
// exp(m_old - m_new); then P, rounded to bf16 in registers, is the A
// operand of O += P V, with V read MN-major from the same swizzled tile.
// No score tile touches shared memory.  Epilogue: o = O / l, rounded to
// bf16, and lse = scale * m + log(l), for rows < T.  One CTA's 81 KB of
// shared memory (D=128) lets two share an SM, one's softmax overlapping
// the other's products.  Tried on the H100 and not kept, as each ran
// slower than this at every shape timed: issuing S of tile j with P V of
// tile j-1, so that one warpgroup's softmax overlaps its own value product
// (FlashAttention-3's intra-warpgroup pipelining); one V
// buffer, so that three CTAs share an SM (a second barrier a tile); and
// skipping O's rescale where alpha is 1 across a warp (a vote a tile).
//
// Numerics, bf16.  q and k are exact bf16 values, so S from bf16 tensor
// cores with fp32 accumulation is the reference's fp32 product up to the
// order of the sum.  The departure: P is rounded to bf16 before the value
// product, where the Pallas kernel keeps it in fp32 (the JAX package's dense
// path rounds it so too, ops/flash_attention.py::_dense_ref).  l is summed
// from the fp32 P before the rounding, so lse stays the fp32 quantity the
// backward recomputes P against.  kernels/flash_attention.py::
// flash_fwd_reference(pd_dtype=torch.bfloat16) models the rounding; the
// kernel rounds exp(s - m_running) and rescales later where the model
// rounds exp(s - m_final), so the two differ within a bf16 step: the
// kernel is held within 1 bf16 step at scale of the model and 2 of the
// reference run in float64, lse within 16 fp32 ulps.
//
// fp32 inputs: the CUDA-core kernel (simt::flash_fwd_kernel), all in fp32
// as the reference upcasts K, V and P.  One CTA of 128 threads per
// (64-query block, b*h) over 32-key tiles; the scaled Q tile stays in
// shared memory, each K/V tile is loaded once and used by all 64 queries.
// Thread (ty, tx) owns query rows ty*4 .. ty*4+3, so the row state (m, l)
// and the output rows are thread-local; the 8 threads of a row reduce max
// and sum with shuffles.  Q, K and P are kept transposed in shared memory,
// so each step of a dot reads four rows (or keys) with one 16-byte load.
//
// Bound: 2 * T^2 * H * D * B FLOPs for causal attention (4 * T^2 * H * D * B
// when full) over the dense bf16 tensor-core peak, 989 TFLOP/s on an H100
// SXM, or the bytes of q, k, v, o and lse, each moved once, over 3.35 TB/s,
// whichever is longer: the FLOPs at the 8B prefill and 1.3B train shapes
// (D=128), the bytes at the GPT-2 train shape (D=64, T=1024, no GQA).  The
// fp32 kernel runs on the CUDA cores (67 TFLOP/s fp32) and sits far above
// the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_wgmma.cuh"

namespace {
namespace simt {

constexpr int kThreads = 128;
constexpr int BQ = 64;       // queries per CTA
constexpr int BK = 32;       // keys per tile
constexpr int RQ = BQ / 16;  // query rows per thread: ty*4 .. ty*4+3
constexpr int CK = BK / 8;   // key columns per thread: tx*4 .. tx*4+3
constexpr int QP = BQ + 4;   // row of the transposed Q and P tiles (16-byte aligned, banks spread)
constexpr int KP = BK + 4;   // row of the transposed K tile
constexpr float kNegInf = -1e30f;

// 16 bytes of global memory (4 floats), loaded raw and converted to fp32
// later.  The wrapper checks that every tensor starts on a
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
        for (int e = 0; e < 4; ++e) orow[mm * 32 + tx * 4 + e] = acc[i][mm * 4 + e] / ls;
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
}  // namespace simt

// ------------------------------------------------- tensor-core kernel
// bf16 inputs only; see the design note at the top of the file.
namespace tc {

constexpr int BQ = kRows;  // queries a CTA
constexpr int BK = 64;     // keys a tile
constexpr float kNegInf = -1e30f;

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = 64 * D * 2;
  static constexpr int q = 0;
  __host__ __device__ static constexpr int k(int s) { return (1 + 2 * s) * kTile; }
  __host__ __device__ static constexpr int v(int s) { return (2 + 2 * s) * kTile; }
  static constexpr int bytes = 5 * kTile + 1024;  // + the alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int seq, int H, int KV, float scale,
    int causal) {
  using S = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int rep = H / KV;
  const int kvrow = (bh / H) * KV + (bh % H) / rep;
  const bf16* kp = k + (size_t)kvrow * seq * D;
  const bf16* vp = v + (size_t)kvrow * seq * D;
  const int tid = threadIdx.x;

  int nkb = (seq + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);

  load_tile<BQ, D>(base + S::q, q + (size_t)bh * seq * D, q0, seq, tid);
  load_tile<BK, D>(base + S::k(0), kp, 0, seq, tid);
  load_tile<BK, D>(base + S::v(0), vp, 0, seq, tid);
  cp_async_commit();

  // this thread's query rows: row and row + 8 of the block.  m is the row
  // max of the unscaled scores q.k (scale > 0, so scale * m is the max of
  // the scaled ones, rounded alike); l this lane's part of the row sum (its
  // 16 of each tile's 64 columns), summed across the row's four lanes at
  // the end.  exp(scale * s - scale * m) is taken as exp2 of one FMA
  const int row = (tid / 32) * 16 + (tid % 32) / 4;
  const float scale_log2 = scale * kLog2e;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    const int st = kb & 1;
    cp_async_drain();
    __syncthreads();  // tile kb is in; every thread is done with tile kb-1's stage
    if (kb + 1 < nkb) {
      load_tile<BK, D>(base + S::k(st ^ 1), kp, k0 + BK, seq, tid);
      load_tile<BK, D>(base + S::v(st ^ 1), vp, k0 + BK, seq, tid);
      cp_async_commit();
    }

    // S = Q K^T
    wg_fence();
    pin(s);
    gemm_ss<BK, D>(s, base + S::q, base + S::k(st));
    wg_commit();
    wg_wait<0>();
    pin(s);

    // mask (element i: row row + 8 * ((i >> 1) & 1), key
    // k0 + (i >> 2) * 8 + 2 * (tid % 4) + (i & 1)); the new row max
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq;
    auto masked = [&](int i) {
      const int qr = q0 + row + 8 * ((i >> 1) & 1);
      const int kc = k0 + (i >> 2) * 8 + 2 * (tid % 4) + (i & 1);
      return kc >= seq || (causal && kc > qr);
    };
    float m_new[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (edge && masked(i)) s[i] = kNegInf;
      m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], s[i]);
    }
    float alpha[2], m_log2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = exp2f((m[h] - m_new[h]) * scale_log2);
      m[h] = m_new[h];
      m_log2[h] = m[h] * scale_log2;
      l[h] *= alpha[h];
    }
    // P in fp32, masked to 0 after the exp; l sums it before the rounding
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(fmaf(s[i], scale_log2, -m_log2[h]));
      if (edge && masked(i)) p = 0.f;
      s[i] = p;
      l[h] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P V, P rounded to bf16 in registers; V read MN-major
    uint32_t pa[BK / 16][4];
    to_fragments<BK>(s, pa);
    wg_fence();
    pin(acc);
    gemm_rs<BK, D>(acc, pa, base + S::v(st));
    wg_commit();
    wg_wait<0>();
    pin(acc);
    pin(pa);
  }

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l_safe[h] = l[h] == 0.f ? 1.f : l[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = acc[i] / l_safe[(i >> 1) & 1];
  store_rows<D>(acc, o + (size_t)bh * seq * D, q0, seq, tid);
  if (tid % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qr = q0 + row + 8 * h;
      if (qr < seq) lse[(size_t)bh * seq + qr] = m[h] * scale + logf(l_safe[h]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int BH, int seq,
           int H, int KV, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(BH, (seq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, seq, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace tc

}  // namespace

// Returns the launch's cudaError_t (0 on success).  is_bf16 selects bf16
// (1: the tensor-core kernel) or fp32 (0: the CUDA-core kernel) for q, k, v
// and o.
extern "C" int vtt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int BH, int seq, int D,
                             int H, int KV, float scale, int causal,
                             int is_bf16, void* stream) {
  if (BH <= 0 || seq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || BH % H != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? tc::launch<64>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st)
                   : simt::launch<float, 64>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? tc::launch<128>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st)
                   : simt::launch<float, 128>(q, k, v, o, lse, BH, seq, H, KV, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
