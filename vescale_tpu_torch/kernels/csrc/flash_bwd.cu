// Flash-attention backward for Hopper (sm_90a): two kernels, dQ and dK/dV.
//
// Replaces the Pallas TPU kernels of vescale_tpu/kernels/flash_attention.py:
// ::_dq_kernel and ::_dq_kernel_stream (by the dq kernel below), ::_dkv_kernel
// and ::_dkv_kernel_stream (by the dkv kernel), launched by
// ::_flash_bwd_pallas and ::_flash_bwd_pallas_stream.  The TPU needed
// streaming variants for its VMEM budget; on Hopper each kernel streams its
// inner operand through shared memory at any T.
//
// Computes the flash decomposition with probabilities recomputed from the
// forward's logsumexp, all in fp32 as the reference upcasts every operand:
//   s  = scale * (q . k)         masked to p = 0 where the reference writes -1e30
//   p  = exp(s - lse)
//   dp = do . v
//   ds = p * (dp - delta) * scale     delta = rowsum(do * o), made by the caller
//   dq = sum_k ds * k,   dk = sum_q ds * q,   dv = sum_q p * do
// Layout: q, do, dq (B*H, T, D); k, v, dk, dv (B*KV, T, D); lse, delta
// (B*H, T) fp32.  q row b reads kv row (b / H) * KV + (b % H) / (H / KV); kv
// row b gathers q rows (b / KV) * H + (b % KV) * rep + r, r < rep, so GQA
// never repeats K/V and dk/dv sum the group's heads in fp32 before one cast
// (the reference's fp32 group sum).  Any T: rows and keys past T are masked.
// D is 64 or 128; fp32 or bf16 inputs, outputs in the input dtype.
//
// Design.  No atomics and no split of a sum across CTAs, so the result is
// the same from run to run (the port's determinism rule).
//   dq:  one CTA of 128 threads per (64-query block, b*h); it loops over
//        32-key tiles up to the causal diagonal.  Q and dO stay in shared
//        memory, transposed; each K/V tile is loaded once.  Thread (ty, tx)
//        owns query rows ty*4 .. ty*4+3 and, for the score tiles, key columns
//        tx*4 .. tx*4+3, so every dot step reads 4 values with one 16-byte
//        shared load.  dS goes through shared memory for dQ += dS.K.  Query
//        blocks are issued last-first, so the long causal rows start early.
//   dkv: one CTA of 128 threads per (64-key block, b*kv); it loops over the
//        rep q heads of the group and over 32-query tiles from the diagonal
//        on, with K and V resident (transposed).  Thread (ty, tx) owns key
//        rows ty*4 .. ty*4+3 and the same dK, dV elements at every level of
//        a three-level fp32 sum: each tile's 32 queries in registers, 8
//        tiles in shared memory, and the running total over the group's
//        rep * T queries in a global fp32 scratch, cast once at the end.  A
//        single sequential fp32 sum over the 8192 queries of the 1.3B
//        group drifted ~40 ulps at scale from the reference's products
//        (41 against an fp64 sum in a numpy model of it); blocked, ~3.
//
// Bound: dq does 3 products of T x T x D per head (6 T^2 H D FLOPs full,
// half that causal), dkv 4 (8 T^2 H D full, half causal), against the dense
// bf16 tensor-core peak; the bytes of q, k, v, do, lse, delta and the grads
// are far below that.  These kernels do their dots in fp32 on the CUDA
// cores, as the reference upcasts P, dS and every operand to fp32, so they
// sit far above their tensor-core bound.  A wgmma design with bf16 P and dS
// is the later work, and would have to state that departure in its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
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

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, void* dq_out, int BH, int seq, int H, int KV, float scale,
              int causal, cudaStream_t stream) {
  constexpr int bytes = dq::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dq::kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + dq::BQ - 1) / dq::BQ, BH);
  dq::kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq_out), seq, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk_out, void* dv_out, float* total, int BKVrows,
               int seq, int H, int KV, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = dkv::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(dkv::kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((seq + dkv::BKV - 1) / dkv::BKV, BKVrows);
  dkv::kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk_out), static_cast<T*>(dv_out),
      total, seq, H, KV, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int seq, int H, int KV) {
  return BH <= 0 || seq <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || BH % H != 0;
}

}  // namespace

// Each returns the launch's cudaError_t (0 on success).  is_bf16 selects
// bf16 (1) or fp32 (0) for q, k, v, do and the grads; lse and delta are
// fp32 (B*H, T).  The dkv kernel also takes `total`, an fp32 scratch of
// 2 * B*KV * T * D values that it writes before it reads.
extern "C" int vtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, void* dq_out, int BH,
                                int seq, int D, int H, int KV, float scale, int causal,
                                int is_bf16, void* stream) {
  if (bad_shape(BH, seq, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, st)
                   : launch_dq<float, 64>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, st)
                   : launch_dq<float, 128>(q, k, v, dout, lse, delta, dq_out, BH, seq, H, KV, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int vtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, void* dk_out,
                                 void* dv_out, float* total, int BH, int seq, int D, int H,
                                 int KV, float scale, int causal, int is_bf16, void* stream) {
  if (bad_shape(BH, seq, H, KV)) return static_cast<int>(cudaErrorInvalidValue);
  const int bkv_rows = BH / H * KV;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV, scale, causal, st)
                   : launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV, scale, causal, st)
                   : launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk_out, dv_out, total, bkv_rows, seq, H, KV, scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
