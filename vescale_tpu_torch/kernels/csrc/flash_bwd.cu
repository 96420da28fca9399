// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of vescale_tpu/kernels/flash_attention.py:
// ::_dq_kernel and ::_dq_kernel_stream (by the dq kernels below), ::_dkv_kernel
// and ::_dkv_kernel_stream (by the dkv kernels), launched by
// ::_flash_bwd_pallas and ::_flash_bwd_pallas_stream.  The TPU needed
// streaming variants for its VMEM budget; on Hopper each kernel streams its
// inner operand through shared memory at any T.
//
// Computes the flash decomposition with probabilities recomputed from the
// forward's logsumexp:
//   s  = scale * (q . k)         masked to p = 0 where the reference writes -1e30
//   p  = exp(s - lse)
//   dp = do . v
//   ds = p * (dp - delta) * scale     delta = rowsum(do * o), made by the caller
//   dq = sum_k ds * k,   dk = sum_q ds * q,   dv = sum_q p * do
// Layout: q, do, dq (B*H, T, D); k, v, dk, dv (B*KV, T, D); lse, delta
// (B*H, T) fp32.  q row b reads kv row (b / H) * KV + (b % H) / (H / KV); kv
// row b gathers q rows (b / KV) * H + (b % KV) * rep + r, r < rep, so GQA
// never repeats K/V and dk/dv sum the group's heads in fp32 before one cast.
// Any T: rows and keys past T are masked.  D is 64 or 128; outputs in the
// input dtype.  No atomics and no split of a sum across CTAs, so the result
// is bitwise the same from run to run (the port's determinism rule).
//
// bf16 inputs: tensor-core kernels (namespace tc).  One warpgroup (128
// threads) a CTA; every product is a wgmma with fp32 accumulators.
//   dq:  one CTA per (64-query block, b*h), blocks launched last-first so the
//        long causal rows start early.  Q and dO stay in shared memory; K/V
//        tiles of 64 keys stream through a two-stage cp.async ring up to
//        the diagonal.  S = Q K^T and dP = dO V^T read both operands from
//        shared memory (K-major); P and dS are formed in fp32 registers and
//        dS, rounded to bf16 in registers, is the A operand of dQ += dS K,
//        with K read MN-major (transposed) from the same tile.
//   dkv: one CTA per (64-key block, b*kv), the blocks with the most causal
//        queries first.  K and V stay in shared memory; Q, dO, lse and delta
//        tiles of 64 queries stream through the ring, over the group's rep
//        q heads and, in each, from the causal diagonal on.  The CTA works
//        transposed: S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T,
//        rounded to bf16 in registers, are the A operands of dV += P^T dO
//        and dK += dS^T Q (FlashAttention-3's layout trick: no score tile
//        goes through shared memory).  dK and dV stay in fp32 registers
//        over all rep * T queries and are cast once; no scratch.
// Tiles sit in shared memory 128-byte swizzled (TMA's SWIZZLE_128B), so
// one tile serves as a K-major and as an MN-major operand.
//
// Numerics, bf16.  q, k, v and do are exact bf16 values, so S and dP from
// bf16 tensor cores with fp32 accumulation are the reference's fp32 products
// up to the order of the sum.  The departure: P and dS are rounded to bf16
// before the dV, dK and dQ products, where the Pallas kernels keep them in
// fp32 (the JAX package's XLA backward on a TPU rounds them so too, as XLA
// runs an fp32 dot at DEFAULT precision as one bf16 pass).
// kernels/flash_attention.py::flash_bwd_reference(pd_dtype=torch.bfloat16)
// models it; the kernels are held within 2 bf16 steps at scale of the
// float64 reference and 1 of that model.  A single fp32 accumulator over the
// 1.3B group's 8192 queries drifts ~40 fp32 ulps, far under one bf16 step
// (2^16 ulps), so dK/dV need no blocked sum here.
//
// fp32 inputs: CUDA-core kernels (namespace simt), all in fp32 as the
// reference upcasts every operand.
//   dq:  one CTA of 128 threads per (64-query block, b*h) over 32-key tiles;
//        Q and dO in shared memory, transposed; dS goes through shared
//        memory for dQ += dS.K.
//   dkv: one CTA of 128 threads per (64-key block, b*kv) over the group's
//        32-query tiles, summing dK and dV in three fp32 levels (registers,
//        8 tiles in shared memory, the total over the group's rep * T
//        queries in the caller's global fp32 scratch), cast once at the end:
//        a single sequential fp32 sum drifted ~40 ulps at scale, blocked ~3.
//
// Bound: dq does 3 products of T x T x D per head (6 T^2 H D FLOPs full,
// half that causal), dkv 4 (8 T^2 H D); the bytes of q, k, v, do, lse,
// delta and the grads are far below that.  The bf16 kernels are held to
// those FLOPs over the dense bf16 tensor-core peak (989 TFLOP/s on an H100
// SXM); they recompute S and dP in both kernels to need no atomics (7 T x T
// x D products where a kernel with an atomic dQ does 5).  The fp32 kernels
// run on the CUDA cores (67 TFLOP/s fp32) and sit far above that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_wgmma.cuh"

namespace {

constexpr int kThreads = 128;

namespace simt {
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// A (ROWS, D) tile of a (seq, D) matrix from row r0, in 16-byte pieces.  For
// the transposed tile, consecutive threads take consecutive rows, so the
// stores dst[c * LD + r] hit distinct banks; for the row-major one,
// consecutive pieces of a row.  Rows past seq read row seq-1 and store zero.
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
                                                 float* dst, int tid) {
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx % ROWS;
      const int c = (idx / ROWS) * NV;
      const bool in = r0 + r < seq;
      float val[NV];
      Vec<T>::to_float(raw[it], val);
#pragma unroll
      for (int e = 0; e < NV; ++e) dst[(c + e) * LD + r] = in ? val[e] : 0.f;
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

// ------------------------------------------------------------------- dq
namespace dq {
constexpr int BQ = 64;      // queries per CTA
constexpr int BK = 32;      // keys per tile
constexpr int QP = BQ + 4;  // row of the transposed Q, dO and dS tiles
constexpr int KP = BK + 4;  // row of the transposed K and V tiles

template <int D>
constexpr int smem_bytes() {
  // qT, doT [D][QP]; kT, vT [D][KP]; k_s [BK][D]; dsT [BK][QP]
  return (2 * D * QP + 2 * D * KP + BK * D + BK * QP) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int seq, int H, int KV, float scale, int causal) {
  constexpr int CD = D / 8;  // dq columns per thread: mm*32 + tx*4 + e
  static_assert(D % 32 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* qT = smem;             // [D][QP]
  float* doT = qT + D * QP;     // [D][QP]
  float* kT = doT + D * QP;     // [D][KP]
  float* vT = kT + D * KP;      // [D][KP]
  float* k_s = vT + D * KP;     // [BK][D]
  float* dsT = k_s + BK * D;    // [BK][QP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int bh = blockIdx.y;
  const int rep = H / KV;
  const int kvrow = (bh / H) * KV + (bh % H) / rep;
  const T* qp = q + (size_t)bh * seq * D;
  const T* dop = dout + (size_t)bh * seq * D;
  const T* kp = k + (size_t)kvrow * seq * D;
  const T* vp = v + (size_t)kvrow * seq * D;

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;

  {
    using QTile = Tile<T, D, BQ>;
    uint4 qraw[QTile::ITERS], draw[QTile::ITERS];
    QTile::load_t(qp, q0, seq, tid, qraw);
    QTile::load_t(dop, q0, seq, tid, draw);
    QTile::template store_t<QP>(qraw, q0, seq, qT, tid);
    QTile::template store_t<QP>(draw, q0, seq, doT, tid);
  }

  float row_lse[4], row_delta[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = min(q0 + ty * 4 + i, seq - 1);
    row_lse[i] = lse[(size_t)bh * seq + qr];
    row_delta[i] = delta[(size_t)bh * seq + qr];
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  int nkb = (seq + BK - 1) / BK;
  if (causal) nkb = min(nkb, (q0 + BQ - 1) / BK + 1);

  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous tiles are consumed (and qT, doT written)
    {
      using KTile = Tile<T, D, BK>;
      uint4 ktraw[KTile::ITERS], kraw[KTile::ITERS], vraw[KTile::ITERS];
      KTile::load_t(kp, k0, seq, tid, ktraw);  // every load issued before
      KTile::load(kp, k0, seq, tid, kraw);     // the first store
      KTile::load_t(vp, k0, seq, tid, vraw);
      KTile::template store_t<KP>(ktraw, k0, seq, kT, tid);
      KTile::store(kraw, k0, seq, k_s, tid);
      KTile::template store_t<KP>(vraw, k0, seq, vT, tid);
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], b[4], g[4], w[4];
      load4(&qT[c * QP + ty * 4], a);
      load4(&kT[c * KP + tx * 4], b);
      load4(&doT[c * QP + ty * 4], g);
      load4(&vT[c * KP + tx * 4], w);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += g[i] * w[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        const bool keep = qr < seq && kc < seq && (!causal || kc <= qr);
        const float p = keep ? expf(scale * s[i][j] - row_lse[i]) : 0.f;
        dsT[(tx * 4 + j) * QP + ty * 4 + i] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float d[4];
      load4(&dsT[kk * QP + ty * 4], d);
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm) {
        float kv[4];
        load4(&k_s[kk * D + mm * 32 + tx * 4], kv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][mm * 4 + e] += d[i] * kv[e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty * 4 + i;
    if (qr < seq) {
      T* row = dq + ((size_t)bh * seq + qr) * D;
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm)
#pragma unroll
        for (int e = 0; e < 4; ++e) store(row + mm * 32 + tx * 4 + e, acc[i][mm * 4 + e]);
    }
  }
}
}  // namespace dq

// ------------------------------------------------------------------ dkv
namespace dkv {
constexpr int BKV = 64;      // keys per CTA
constexpr int BQ = 32;       // queries per tile
constexpr int KP = BKV + 4;  // row of the transposed K, V tiles and of the P, dS tiles
constexpr int QP = BQ + 4;   // row of the transposed Q and dO tiles

constexpr int kTilesPerFlush = 8;  // query tiles summed in shared memory per global add

template <int D>
constexpr int smem_bytes() {
  // kT, vT [D][KP]; qT, doT [D][QP]; q_s, do_s [BQ][D]; p_s, ds_s [BQ][KP];
  // mid_k, mid_v [BKV][D]
  return (2 * D * KP + 2 * D * QP + 2 * BQ * D + 2 * BQ * KP + 2 * BKV * D) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ total, int seq, int H, int KV,
    float scale, int causal) {
  constexpr int CD = D / 8;  // dk/dv columns per thread: mm*32 + tx*4 + e
  static_assert(D % 32 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* kT = smem;            // [D][KP]
  float* vT = kT + D * KP;     // [D][KP]
  float* qT = vT + D * KP;     // [D][QP]
  float* doT = qT + D * QP;    // [D][QP]
  float* q_s = doT + D * QP;   // [BQ][D]
  float* do_s = q_s + BQ * D;  // [BQ][D]
  float* p_s = do_s + BQ * D;  // [BQ][KP]
  float* ds_s = p_s + BQ * KP; // [BQ][KP]
  float* mid_k = ds_s + BQ * KP;  // [BKV][D]  sums of up to kTilesPerFlush tiles
  float* mid_v = mid_k + BKV * D;  // [BKV][D]

  const int k0 = blockIdx.x * BKV;
  const int bkv = blockIdx.y;
  float* tot_k = total + (size_t)bkv * seq * D;                  // (2, B*KV, T, D) scratch
  float* tot_v = total + ((size_t)gridDim.y + bkv) * seq * D;
  const int rep = H / KV;
  const T* kp = k + (size_t)bkv * seq * D;
  const T* vp = v + (size_t)bkv * seq * D;

  const int tid = threadIdx.x;
  const int ty = tid / 8;
  const int tx = tid % 8;

  {
    using KTile = Tile<T, D, BKV>;
    uint4 kraw[KTile::ITERS], vraw[KTile::ITERS];
    KTile::load_t(kp, k0, seq, tid, kraw);
    KTile::load_t(vp, k0, seq, tid, vraw);
    KTile::template store_t<KP>(kraw, k0, seq, kT, tid);
    KTile::template store_t<KP>(vraw, k0, seq, vT, tid);
  }

  // this thread's elements: key row ty*4 + i, columns mm*32 + tx*4 .. +3
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mm = 0; mm < D / 32; ++mm) {
      const int at = (ty * 4 + i) * D + mm * 32 + tx * 4;
      *reinterpret_cast<float4*>(&mid_k[at]) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&mid_v[at]) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  int tiles = 0;         // tiles summed into mid since the last flush
  bool flushed = false;  // the global total holds a value

  const int nqb = (seq + BQ - 1) / BQ;
  const int first = causal ? k0 / BQ : 0;  // earlier query tiles see none of these keys

  for (int r = 0; r < rep; ++r) {
    const int qrow = (bkv / KV) * H + (bkv % KV) * rep + r;
    const T* qp = q + (size_t)qrow * seq * D;
    const T* dop = dout + (size_t)qrow * seq * D;
    const float* lsep = lse + (size_t)qrow * seq;
    const float* deltap = delta + (size_t)qrow * seq;

    for (int qb = first; qb < nqb; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();  // the previous tiles are consumed (and kT, vT written)
      {
        using QTile = Tile<T, D, BQ>;
        uint4 qtraw[QTile::ITERS], qraw[QTile::ITERS], dtraw[QTile::ITERS], draw[QTile::ITERS];
        QTile::load_t(qp, q0, seq, tid, qtraw);
        QTile::load(qp, q0, seq, tid, qraw);
        QTile::load_t(dop, q0, seq, tid, dtraw);
        QTile::load(dop, q0, seq, tid, draw);
        QTile::template store_t<QP>(qtraw, q0, seq, qT, tid);
        QTile::store(qraw, q0, seq, q_s, tid);
        QTile::template store_t<QP>(dtraw, q0, seq, doT, tid);
        QTile::store(draw, q0, seq, do_s, tid);
      }
      float col_lse[4], col_delta[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = min(q0 + tx * 4 + j, seq - 1);
        col_lse[j] = lsep[qr];
        col_delta[j] = deltap[qr];
      }
      __syncthreads();

      // s^T and dp^T: rows are this CTA's keys, columns the tile's queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        float a[4], b[4], w[4], g[4];
        load4(&kT[c * KP + ty * 4], a);
        load4(&qT[c * QP + tx * 4], b);
        load4(&vT[c * KP + ty * 4], w);
        load4(&doT[c * QP + tx * 4], g);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += a[i] * b[j];
            dp[i][j] += w[i] * g[j];
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = q0 + tx * 4 + j;
          const bool keep = qr < seq && kc < seq && (!causal || kc <= qr);
          const float p = keep ? expf(scale * s[i][j] - col_lse[j]) : 0.f;
          p_s[(tx * 4 + j) * KP + ty * 4 + i] = p;
          ds_s[(tx * 4 + j) * KP + ty * 4 + i] = p * (dp[i][j] - col_delta[j]) * scale;
        }
      }
      __syncthreads();

      float acc_k[4][CD], acc_v[4][CD];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float p[4], d[4];
        load4(&p_s[qq * KP + ty * 4], p);
        load4(&ds_s[qq * KP + ty * 4], d);
#pragma unroll
        for (int mm = 0; mm < D / 32; ++mm) {
          float g[4], a[4];
          load4(&do_s[qq * D + mm * 32 + tx * 4], g);
          load4(&q_s[qq * D + mm * 32 + tx * 4], a);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc_v[i][mm * 4 + e] += p[i] * g[e];
              acc_k[i][mm * 4 + e] += d[i] * a[e];
            }
        }
      }
      // mid += this tile; every kTilesPerFlush tiles, total += mid
      const bool flush = ++tiles == kTilesPerFlush;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + ty * 4 + i;
#pragma unroll
        for (int mm = 0; mm < D / 32; ++mm) {
          const int col = mm * 32 + tx * 4;
          float* mk = &mid_k[(ty * 4 + i) * D + col];
          float* mv = &mid_v[(ty * 4 + i) * D + col];
          float nk[4], nv[4];
          load4(mk, nk);
          load4(mv, nv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            nk[e] += acc_k[i][mm * 4 + e];
            nv[e] += acc_v[i][mm * 4 + e];
          }
          if (flush) {
            if (kc < seq) {
              float* gk = tot_k + (size_t)kc * D + col;
              float* gv = tot_v + (size_t)kc * D + col;
              if (flushed) {
                float ok[4], ov[4];
                load4(gk, ok);
                load4(gv, ov);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  nk[e] = ok[e] + nk[e];
                  nv[e] = ov[e] + nv[e];
                }
              }
              *reinterpret_cast<float4*>(gk) = make_float4(nk[0], nk[1], nk[2], nk[3]);
              *reinterpret_cast<float4*>(gv) = make_float4(nv[0], nv[1], nv[2], nv[3]);
            }
            nk[0] = nk[1] = nk[2] = nk[3] = nv[0] = nv[1] = nv[2] = nv[3] = 0.f;
          }
          *reinterpret_cast<float4*>(mk) = make_float4(nk[0], nk[1], nk[2], nk[3]);
          *reinterpret_cast<float4*>(mv) = make_float4(nv[0], nv[1], nv[2], nv[3]);
        }
      }
      if (flush) {
        tiles = 0;
        flushed = true;
      }
    }
  }

  // the result: total + the tiles still in mid, cast once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + ty * 4 + i;
    if (kc < seq) {
      T* krow = dk + ((size_t)bkv * seq + kc) * D;
      T* vrow = dv + ((size_t)bkv * seq + kc) * D;
#pragma unroll
      for (int mm = 0; mm < D / 32; ++mm) {
        const int col = mm * 32 + tx * 4;
        float nk[4], nv[4];
        load4(&mid_k[(ty * 4 + i) * D + col], nk);
        load4(&mid_v[(ty * 4 + i) * D + col], nv);
        if (flushed) {
          float ok[4], ov[4];
          load4(tot_k + (size_t)kc * D + col, ok);
          load4(tot_v + (size_t)kc * D + col, ov);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            nk[e] = ok[e] + nk[e];
            nv[e] = ov[e] + nv[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          store(krow + col + e, nk[e]);
          store(vrow + col + e, nv[e]);
        }
      }
    }
  }
}
}  // namespace dkv
}  // namespace simt

// ------------------------------------------------- tensor-core kernels
// bf16 inputs only.  One warpgroup (128 threads) a CTA runs every
// product as a wgmma, with the helpers of tc_wgmma.cuh; see the design
// note at the top of the file.
namespace tc {

// ------------------------------------------------------------------ dq
namespace dq {
constexpr int BQ = kRows;  // queries a CTA
constexpr int BK = 64;     // keys a tile

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = 64 * D * 2;
  static constexpr int q = 0, dout = kTile;
  __host__ __device__ static constexpr int k(int s) { return (2 + 2 * s) * kTile; }
  __host__ __device__ static constexpr int v(int s) { return (3 + 2 * s) * kTile; }
  static constexpr int bytes = 6 * kTile + 1024;  // + the alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int seq, int H, int KV, float scale, int causal) {
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
  load_tile<BQ, D>(base + S::dout, dout + (size_t)bh * seq * D, q0, seq, tid);
  load_tile<BK, D>(base + S::k(0), kp, 0, seq, tid);
  load_tile<BK, D>(base + S::v(0), vp, 0, seq, tid);
  cp_async_commit();

  // this thread's two query rows; lse pre-scaled for exp2, rows past seq 0
  const int row = (tid / 32) * 16 + (tid % 32) / 4;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = q0 + row + 8 * h;
    row_lse[h] = qr < seq ? lse[(size_t)bh * seq + qr] * kLog2e : 0.f;
    row_delta[h] = qr < seq ? delta[(size_t)bh * seq + qr] : 0.f;
  }
  const float scale_log2 = scale * kLog2e;

  float acc[D / 2], s[BK / 2], dp[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;

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

    // S = Q K^T and dP = dO V^T, two groups so P starts while dP runs
    wg_fence();
    pin(s);
    pin(dp);
    gemm_ss<BK, D>(s, base + S::q, base + S::k(st));
    wg_commit();
    gemm_ss<BK, D>(dp, base + S::dout, base + S::v(st));
    wg_commit();
    wg_wait<1>();
    pin(s);

    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > seq || q0 + BQ > seq;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = exp2f(s[i] * scale_log2 - row_lse[h]);
      if (edge) {
        const int qr = q0 + row + 8 * h;
        const int kc = k0 + (i >> 2) * 8 + 2 * (tid % 4) + (i & 1);
        if (qr >= seq || kc >= seq || (causal && kc > qr)) p = 0.f;
      }
      s[i] = p;
    }
    wg_wait<0>();
    pin(dp);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) dp[i] = s[i] * (dp[i] - row_delta[(i >> 1) & 1]) * scale;

    // dQ += dS K, dS rounded to bf16 in registers; K read MN-major
    uint32_t ds[BK / 16][4];
    to_fragments<BK>(dp, ds);
    wg_fence();
    pin(acc);
    gemm_rs<BK, D>(acc, ds, base + S::k(st));
    wg_commit();
    wg_wait<0>();
    pin(acc);
    pin(ds);
  }
  store_rows<D>(acc, dq + (size_t)bh * seq * D, q0, seq, tid);
}
}  // namespace dq

// ----------------------------------------------------------------- dkv
namespace dkv {
constexpr int BKV = kRows;  // keys a CTA
constexpr int BQ = 64;      // queries a tile

template <int D>
struct Smem {  // byte offsets from a 1024-aligned base
  static constexpr int kTile = BKV * D * 2, qTile = BQ * D * 2;
  static constexpr int k = 0, v = kTile;
  __host__ __device__ static constexpr int q(int s) { return 2 * kTile + 2 * s * qTile; }
  __host__ __device__ static constexpr int dout(int s) { return 2 * kTile + (2 * s + 1) * qTile; }
  // lse then delta, BQ floats each
  __host__ __device__ static constexpr int vec(int s) { return 2 * kTile + 4 * qTile + s * 8 * BQ; }
  static constexpr int bytes = 2 * kTile + 4 * qTile + 4 * BQ * 4 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int H, int KV, float scale,
    int causal) {
  using S = Smem<D>;
  static_assert(2 * BQ <= kThreads, "one lse or delta value a thread");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const float* smem = reinterpret_cast<const float*>(smem_raw + (base - raw));  // at base

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * BKV;  // the key blocks with the most causal queries first
  const int rep = H / KV;
  const int tid = threadIdx.x;

  // the tiles: the group's rep q heads, each from the causal diagonal on
  const int first = causal ? k0 / BQ : 0;
  const int per_head = (seq + BQ - 1) / BQ - first;
  const int ntiles = rep * per_head;

  // tile i: Q, dO, lse and delta of q head (bkv / KV) * H + (bkv % KV) * rep + i / per_head
  auto load_q_tile = [&](int i) {
    const int qrow = (bkv / KV) * H + (bkv % KV) * rep + i / per_head;
    const int q0 = (first + i % per_head) * BQ;
    const int st = i & 1;
    load_tile<BQ, D>(base + S::q(st), q + (size_t)qrow * seq * D, q0, seq, tid);
    load_tile<BQ, D>(base + S::dout(st), dout + (size_t)qrow * seq * D, q0, seq, tid);
    if (tid < 2 * BQ) {
      const int qr = q0 + tid % BQ;
      const float* src = (tid < BQ ? lse : delta) + (size_t)qrow * seq;
      cp_async4(base + S::vec(st) + tid * 4, src + min(qr, seq - 1), qr < seq ? 4 : 0);
    }
  };
  load_tile<BKV, D>(base + S::k, k + (size_t)bkv * seq * D, k0, seq, tid);
  load_tile<BKV, D>(base + S::v, v + (size_t)bkv * seq * D, k0, seq, tid);
  if (ntiles > 0) load_q_tile(0);
  cp_async_commit();

  const float scale_log2 = scale * kLog2e;
  const int key = k0 + (tid / 32) * 16 + (tid % 32) / 4;  // this thread's key rows: key, key + 8
  float acc_k[D / 2], acc_v[D / 2], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int q0 = (first + i % per_head) * BQ;
    const int st = i & 1;
    cp_async_drain();
    __syncthreads();  // tile i is in; every thread is done with tile i-1's stage
    if (i + 1 < ntiles) {
      load_q_tile(i + 1);
      cp_async_commit();
    }
    const float* lse_s = smem + S::vec(st) / 4;
    const float* delta_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    wg_fence();
    pin(s);
    pin(dp);
    gemm_ss<BQ, D>(s, base + S::k, base + S::q(st));
    wg_commit();
    gemm_ss<BQ, D>(dp, base + S::v, base + S::dout(st));
    wg_commit();
    wg_wait<1>();
    pin(s);

    const bool edge = (causal && q0 < k0 + BKV - 1) || q0 + BQ > seq || k0 + BKV > seq;
#pragma unroll
    for (int i2 = 0; i2 < BQ / 2; ++i2) {
      const int col = (i2 >> 2) * 8 + 2 * (tid % 4) + (i2 & 1);
      float p = exp2f(s[i2] * scale_log2 - lse_s[col] * kLog2e);
      if (edge) {
        const int kr = key + 8 * ((i2 >> 1) & 1);
        const int qc = q0 + col;
        if (kr >= seq || qc >= seq || (causal && kr > qc)) p = 0.f;
      }
      s[i2] = p;
    }
    wg_wait<0>();
    pin(dp);
#pragma unroll
    for (int i2 = 0; i2 < BQ / 2; ++i2) {
      const int col = (i2 >> 2) * 8 + 2 * (tid % 4) + (i2 & 1);
      dp[i2] = s[i2] * (dp[i2] - delta_s[col]) * scale;
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T rounded to bf16 in
    // registers; dO and Q read MN-major from the tiles S^T and dP^T used
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_fragments<BQ>(s, pa);
    to_fragments<BQ>(dp, da);
    wg_fence();
    pin(acc_v);
    pin(acc_k);
    gemm_rs<BQ, D>(acc_v, pa, base + S::dout(st));
    gemm_rs<BQ, D>(acc_k, da, base + S::q(st));
    wg_commit();
    wg_wait<0>();
    pin(acc_v);
    pin(acc_k);
    pin(pa);
    pin(da);
  }
  store_rows<D>(acc_k, dk + (size_t)bkv * seq * D, k0, seq, tid);
  store_rows<D>(acc_v, dv + (size_t)bkv * seq * D, k0, seq, tid);
}
}  // namespace dkv
}  // namespace tc

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq_out, int BH, int seq, int H, int KV, float scale,
              int causal, int is_bf16, cudaStream_t stream) {
  const dim3 grid(BH, (seq + 63) / 64);
  cudaError_t err;
  if (is_bf16) {
    using tc::bf16;
    constexpr int bytes = tc::dq::Smem<D>::bytes;
    err = cudaFuncSetAttribute(tc::dq::kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::dq::kernel<D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq_out), seq, H, KV, scale,
        causal);
  } else {
    constexpr int bytes = simt::dq::smem_bytes<D>();
    err = cudaFuncSetAttribute(simt::dq::kernel<float, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::dq::kernel<float, D><<<dim3(grid.y, grid.x), kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq_out), seq, H, KV, scale,
        causal);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk_out, void* dv_out, float* total, int BKVrows, int seq,
               int H, int KV, float scale, int causal, int is_bf16, cudaStream_t stream) {
  const dim3 grid(BKVrows, (seq + 63) / 64);
  cudaError_t err;
  if (is_bf16) {
    using tc::bf16;
    constexpr int bytes = tc::dkv::Smem<D>::bytes;
    err = cudaFuncSetAttribute(tc::dkv::kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::dkv::kernel<D><<<grid, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk_out),
        static_cast<bf16*>(dv_out), seq, H, KV, scale, causal);
  } else {
    if (total == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    constexpr int bytes = simt::dkv::smem_bytes<D>();
    err = cudaFuncSetAttribute(simt::dkv::kernel<float, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    simt::dkv::kernel<float, D><<<dim3(grid.y, grid.x), kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk_out),
        static_cast<float*>(dv_out), total, seq, H, KV, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int seq, int H, int KV) {
  return BH <= 0 || seq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || BH % H != 0;
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success).  is_bf16 selects
// bf16 (1: the tensor-core kernels) or fp32 (0: the CUDA-core kernels) for
// q, k, v, do and the grads; lse and delta are fp32 (B*H, T).  The fp32 dkv
// kernel also takes `total`, an fp32 scratch of 2 * B*KV * T * D values
// that it writes before it reads; the bf16 one takes none (null).
extern "C" int vtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq_out, int BH,
                                int seq, int D, int H, int KV, float scale, int causal,
                                int is_bf16, void* stream) {
  if (bad_shape(BH, seq, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, is_bf16,
                         st);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, is_bf16,
                          st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk_out,
                                 void* dv_out, float* total, int BH, int seq, int D, int H,
                                 int KV, float scale, int causal, int is_bf16, void* stream) {
  if (bad_shape(BH, seq, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const int bkv_rows = BH / H * KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV,
                          scale, causal, is_bf16, st);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV,
                           scale, causal, is_bf16, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
