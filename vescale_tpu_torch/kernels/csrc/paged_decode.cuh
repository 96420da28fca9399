// Paged-attention decode for Hopper (sm_90a): the kernel, shared by
// paged_decode.cu (head dims 64 and 128) and paged_decode_pad.cu (the
// padded ones), two libraries that compile in parallel.
//
// Replaces the Pallas TPU kernel vescale_tpu/kernels/paged_attention.py::
// _decode_kernel (launched by ::paged_decode).  One query row per head
// attends to the K/V a slot holds in the paged pool, read straight through
// the slot's page table; positions at or past the slot's length are never
// read.  The softmax is online and in fp32, the output fp32 (S, H, hd).
//
// Layout: q (S, H, hd) fp32 or bf16; k_pool / v_pool (N, page, KV, hd) fp32
// or bf16, page 0 being the null page; table (S, Pmax) int32; lengths (S,)
// int32; out (S, H, hd) fp32.  H = KV * G: q heads [g*G, (g+1)*G) share kv
// head g, as in the TPU kernel's (KV, G, hd) reshape.
//
// Bound: bytes.  The K/V rows the slots hold, S * len * KV * hd * 2 * elt,
// read once, against the card's memory rate; ~2 FMAs a byte for G = 4, far
// below what the CUDA cores do per byte of bandwidth, so no tensor cores
// and no departure from the fp32 reference arithmetic.
//
// Partition (FlashDecoding under the port's determinism rule).  A slot's
// positions are cut into chunks of kChunk = 64 (a chunk may span pages).
// One thread-block cluster of kCluster = 4 CTAs serves each (slot, kv head):
// CTA rank r takes chunks r, r + 4, r + 8, ..., and within a chunk warp w
// takes positions 16w .. 16w + 15.  Each warp keeps its own online (m, l,
// acc[G][hd]) across its steps; at the end each CTA with chunks combines
// its 4 warps in warp order and sends the result into rank 0's shared
// memory (distributed shared memory); rank 0 combines the ranks that had
// chunks in rank order:
// M = max m_r, w_r = exp(m_r - M), l = sum w_r l_r, acc = sum w_r acc_r,
// out = acc / (l == 0 ? 1 : l).  The partition and both orders depend on
// the slot's own length and on nothing else (not S, not other slots, not
// Pmax, not the SM count, not timing), so a slot's output is bitwise the
// same from run to run and in any batch: greedy replay stays bit-identical.
// A warp without positions keeps the empty state (m = -1e30, l = 0,
// acc = 0); a rank without chunks sends nothing (its weight would be
// exactly 0); a slot of length 0 writes 0.  Two phases of the cluster
// barrier: every CTA arrives at the start and waits before it sends (so
// rank 0 is running), arrives again after sending, and only rank 0 waits
// on that second phase; the others exit, so a CTA without chunks frees its
// SM at once and no CTA's shared memory has to outlive its own work.
//
// What this does about the four costs of the first kernel (one CTA of 512
// threads per (slot, kv head), 64 positions a pass):
//  1. Too few CTAs, the longest slot walking alone: S * KV clusters of 4
//     CTAs of 128 threads, three to an SM, and a long slot's chunks spread
//     over 4 SMs.
//  2. Narrow loads and no prefetch: K and V rows go to shared memory with
//     16-byte cp.async (zero-filled past the length, XOR-swizzled so the
//     score phase reads them without bank conflicts) through a 2-3-stage
//     ring per warp: the next step's bytes are in flight while one computes.
//  3. A serial softmax behind four barriers a pass: each warp runs its own
//     online softmax with shuffles (max and sum over its 16 positions, two
//     a lane), so a step has no block barrier, only __syncwarp.
//  4. Page ids read inside the pass: each warp reads its next step's page
//     ids (one lane a row) a step ahead, into registers, so the table read
//     overlaps the current step.
// Shapes chosen by A/B runs on an H100 (PERF.md §6): 4 warps of 16 rows
// and clusters of 4 beat 8 warps of 8 rows and clusters of 8 or 2.
// Head dims: the kernel is compiled at HD = 64 and 128.  A pool of head
// dim hd below either (every hd <= 128 with hd % 4 == 0) runs at the next
// (PAD): its rows keep their own stride hd in the pool, which is never
// padded, and go to shared memory as 8-byte cp.async pieces (a row of
// 2 * hd bf16 bytes is 8-byte aligned, not always 16), the pieces at or
// past hd zero-filled; q_s holds zeros there too, so the scores and the
// V columns past hd are exactly 0, and only the hd columns are written.
// NaN: maxima use fmaxf, which drops a NaN score, but exp(NaN - m) is NaN,
// so a NaN K or V row at a valid position still poisons l and acc of its
// kv group's heads, as in the reference.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16;                  // positions a warp takes in a chunk
constexpr int kRpl = kRows / 8;            // ... and a lane in the score phase
constexpr int kChunk = kWarps * kRows;     // 64 positions
constexpr int kCluster = 4;                // CTAs a (slot, kv head)
constexpr int kMaxStages = 3;              // cp.async ring depth, per warp
constexpr int kSmallBudget = 76 * 1024;    // three CTAs an SM for G <= 4
constexpr int kMaxGroup = 16;              // q heads per kv head
constexpr float kNegInf = -1e30f;

static_assert(kChunk == 64 && kRows % 8 == 0, "the partition's chunk");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of type T at shared address p, as floats
template <typename T, int N>
__device__ __forceinline__ void load_floats(const unsigned char* p, float* f) {
  if constexpr (N * sizeof(T) == 16) {  // one 16-byte shared load
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) f[e] = __uint_as_float(w[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[2 * e] = __uint_as_float(w[e] << 16);
        f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
      }
    }
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + 4 * e);
      f[e] = x.x;
      f[e + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; e += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2 * e));
      f[e] = x.x;
      f[e + 1] = x.y;
    }
  }
}

// Shared memory of one CTA, in bytes (every offset a multiple of 16).  The
// ring takes 3 stages where the CTA still fits its budget (three CTAs an SM
// for G <= 4), else 2.
template <typename TKV, int HD, int MAXG>
struct Smem {
  static constexpr int kRowBytes = HD * (int)sizeof(TKV);
  static constexpr int kStep = 2 * kRows * kRowBytes;             // K, V rows of a warp's step
  static constexpr int kRedAcc = kWarps * MAXG * HD * 4;          // warp partials
  static constexpr int kRedML = 2 * kWarps * MAXG * 4;
  static constexpr int kInboxBytes = (2 * kCluster * MAXG + (kCluster - 1) * MAXG * HD) * 4;
  static constexpr int kRest = MAXG * HD * 4 + kWarps * kRows * MAXG * 4 + kInboxBytes;
  static constexpr int body(int stages) {
    return stages * kWarps * kStep > kRedAcc + kRedML ? stages * kWarps * kStep : kRedAcc + kRedML;
  }
  static constexpr int kBudget = MAXG <= 4 ? kSmallBudget : 227 * 1024;
  static constexpr int kStages = body(kMaxStages) + kRest <= kBudget ? kMaxStages : 2;
  static constexpr int kBody = body(kStages);
  static constexpr int kQ = kBody;                                // q_s [MAXG][HD] fp32
  static constexpr int kP = kQ + MAXG * HD * 4;                   // p_s [kWarps][kRows][MAXG]
  static constexpr int kInbox = kP + kWarps * kRows * MAXG * 4;   // rank 0's, kInboxBytes
  static constexpr int kBytes = kBody + kRest;
  static_assert(kBytes <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <typename TQ, typename TKV, int HD, int MAXG, bool PAD>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, MAXG <= 4 ? 3 : 1)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool, const int* __restrict__ table,
                    const int* __restrict__ lengths, float* __restrict__ out, int H, int KV,
                    int page, int pmax, float scale, int hd_arg) {
  using L = Smem<TKV, HD, MAXG>;
  constexpr int EPP = 16 / (int)sizeof(TKV);  // elements in a 16-byte piece
  constexpr int RB = HD / EPP;                // pieces in a row
  constexpr int CPB = PAD ? 8 : 16;           // bytes a cp.async piece
  constexpr int EPC = CPB / (int)sizeof(TKV);  // elements a cp.async piece
  constexpr int RBC = HD / EPC;                // cp.async pieces in a row
  static_assert((kRows * RBC) % 32 == 0, "a warp's copies");
  const int hd = PAD ? hd_arg : HD;            // the pool's head dim, its row stride
  constexpr int CPL = HD / 32;                // V columns a lane owns
  static_assert(RB >= 8 && RB % 4 == 0, "unsupported head_dim");
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  float* p_s = reinterpret_cast<float*>(smem + L::kP);
  float* inbox = reinterpret_cast<float*>(smem + L::kInbox);  // rank 0's
  float* red_acc = reinterpret_cast<float*>(smem);  // after the ring is done
  float* red_m = reinterpret_cast<float*>(smem + L::kRedAcc);
  float* red_l = red_m + kWarps * MAXG;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  constexpr int kStages = L::kStages;
  // phase 0 of the cluster barrier: this CTA has started (rank 0's inbox
  // may be written once every CTA has)
  cluster_arrive_relaxed();
  const int kvh = blockIdx.y;
  const int s = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // positions past the table's reach are masked, as in the TPU kernel
  const int len = max(0, min(lengths[s], page * pmax));
  const int nchunks = (len + kChunk - 1) / kChunk;
  const int nsteps = rank < nchunks ? (nchunks - 1 - rank) / kCluster + 1 : 0;

  // element offset of row `lane` (< kRows) of this warp's step st, -1 if masked
  auto row_offset = [&](int st) -> long long {
    const int pos = (rank + st * kCluster) * kChunk + warp * kRows + lane;
    if (st >= nsteps || lane >= kRows || pos >= len) return -1;
    const long long pg = table[(size_t)s * pmax + pos / page];
    return ((pg * page + pos % page) * KV + kvh) * (long long)hd;
  };
  const uint32_t ring = (uint32_t)__cvta_generic_to_shared(smem);
  auto issue = [&](int slot, long long offs) {
    const uint32_t kdst = ring + (uint32_t)((slot * kWarps + warp) * L::kStep);
    const uint32_t vdst = kdst + kRows * L::kRowBytes;
#pragma unroll
    for (int i = 0; i < kRows * RBC / 32; ++i) {
      const int p = lane + 32 * i;
      const int row = p / RBC;
      const int pc = p % RBC;
      const long long off = __shfl_sync(0xffffffffu, offs, row);
      const bool in = off >= 0 && (!PAD || pc * EPC < hd);
      const int byte = pc * CPB;  // within the row; the swizzle is in 16-byte units
      const uint32_t at =
          row * L::kRowBytes + ((((byte >> 4) ^ ((row & 1) << 2)) << 4) | (byte & 15));
      const void* ksrc = in ? (const void*)(k_pool + off + pc * EPC) : (const void*)k_pool;
      const void* vsrc = in ? (const void*)(v_pool + off + pc * EPC) : (const void*)v_pool;
      if constexpr (PAD) {
        cp_async8(kdst + at, ksrc, in ? 8 : 0);
        cp_async8(vdst + at, vsrc, in ? 8 : 0);
      } else {
        cp_async16(kdst + at, ksrc, in ? 16 : 0);
        cp_async16(vdst + at, vsrc, in ? 16 : 0);
      }
    }
  };

  float m[MAXG], l[MAXG], acc[MAXG][CPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[g][e] = 0.f;
  }
  // the first steps' copies go out before q is read, so the two latencies overlap
  long long next = row_offset(0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    const long long offs = next;
    next = row_offset(st + 1);
    if (st < nsteps) issue(st, offs);
    cp_async_commit();
  }
  // the kv group's q rows, scaled in fp32 before the dot as the TPU kernel does
  if (nsteps > 0) {
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD;
      const int d = i % HD;
      q_s[g * HD + d] = d < hd ? to_float(q[((size_t)s * H + kvh * G + g) * hd + d]) * scale : 0.f;
    }
  }
  __syncthreads();  // q_s

  const int r = lane >> 2;  // score phase: this lane's rows r, r + 8, ...
  const int c = lane & 3;   // ... and its quarter of each row's pieces
  const int swz = (r & 1) << 2;
  for (int st = 0; st < nsteps; ++st) {
    {
      const int ahead = st + kStages - 1;
      const long long offs = next;
      next = row_offset(ahead + 1);
      if (ahead < nsteps) issue(ahead % kStages, offs);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* kbuf = smem + ((st % kStages) * kWarps + warp) * L::kStep;
    const unsigned char* vbuf = kbuf + kRows * L::kRowBytes;
    const int row0 = (rank + st * kCluster) * kChunk + warp * kRows;

    // scores: 4 lanes a row, each over a quarter of the row's pieces; a q
    // piece read from shared memory serves the lane's kRpl rows
    float sc[kRpl][MAXG];
#pragma unroll
    for (int j = 0; j < kRpl; ++j)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) sc[j][g] = 0.f;
#pragma unroll
    for (int i = 0; i < RB / 4; ++i) {
      const int col = i * 4 + c;
      float kf[kRpl][EPP];
#pragma unroll
      for (int j = 0; j < kRpl; ++j)
        load_floats<TKV, EPP>(kbuf + (r + 8 * j) * L::kRowBytes + ((col ^ swz) << 4), kf[j]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float* qp = q_s + g * HD + col * EPP;
#pragma unroll
          for (int e = 0; e < EPP; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qp + e);
#pragma unroll
            for (int j = 0; j < kRpl; ++j)
              sc[j][g] += qv.x * kf[j][e] + qv.y * kf[j][e + 1] + qv.z * kf[j][e + 2] +
                          qv.w * kf[j][e + 3];
          }
        }
      }
    }

    // online softmax over the warp's kRows rows, every lane alike
    float alpha[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float x[kRpl];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kRpl; ++j) {
          x[j] = sc[j][g];
          x[j] += __shfl_xor_sync(0xffffffffu, x[j], 1);
          x[j] += __shfl_xor_sync(0xffffffffu, x[j], 2);
          x[j] = row0 + r + 8 * j < len ? x[j] : kNegInf;
          mx = fmaxf(mx, x[j]);
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kRpl; ++j) {
          // a NaN score stays NaN here and poisons l and acc of its head
          const float p = row0 + r + 8 * j < len ? expf(x[j] - m_new) : 0.f;
          sum += p;
          if (c == (g & 3)) p_s[(warp * kRows + r + 8 * j) * MAXG + g] = p;
        }
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        alpha[g] = expf(m[g] - m_new);
        l[g] = l[g] * alpha[g] + sum;
        m[g] = m_new;
      } else {
        alpha[g] = 1.f;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P V over the warp's rows, in order
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[g][e] *= alpha[g];
    const int vb = lane * CPL * (int)sizeof(TKV);
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      float vf[CPL];
      load_floats<TKV, CPL>(
          vbuf + rr * L::kRowBytes + ((((vb >> 4) ^ ((rr & 1) << 2)) << 4) | (vb & 15)), vf);
      const float* pp = p_s + (warp * kRows + rr) * MAXG;
#pragma unroll
      for (int g4 = 0; g4 < MAXG; g4 += 4) {
        if (g4 < G) {
          const float4 p4 = *reinterpret_cast<const float4*>(pp + g4);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int g = 0; g < 4; ++g)
#pragma unroll
            for (int e = 0; e < CPL; ++e) acc[g4 + g][e] += pv[g] * vf[e];
        }
      }
    }
    __syncwarp();  // the ring slot and p_s are rewritten by the next step
  }
  cp_async_wait<0>();

  cluster_wait_acquire();  // phase 0: every CTA of the cluster runs

  // the CTA's partial, its warps combined in warp order, goes to rank 0's
  // inbox; a CTA without chunks sends nothing
  // inbox: m and l [kCluster][MAXG], then acc [kCluster - 1][MAXG * HD] of
  // ranks 1..; rank 0 keeps its own acc in red_acc
  float* box_m = rank == 0 ? inbox : cluster.map_shared_rank(inbox, 0);
  float* box_l = box_m + kCluster * MAXG;
  float* box_acc = rank == 0 ? red_acc : box_l + kCluster * MAXG + (rank - 1) * MAXG * HD;
  if (nsteps > 0) {
    __syncthreads();  // every warp is done with the ring that red_* overlays
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < CPL; ++e) red_acc[(warp * MAXG + g) * HD + lane * CPL + e] = acc[g][e];
        if (lane == 0) {
          red_m[warp * MAXG + g] = m[g];
          red_l[warp * MAXG + g] = l[g];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w * MAXG + g]);
      float a = 0.f, lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(red_m[w * MAXG + g] - mx);
        a += wt * red_acc[(w * MAXG + g) * HD + i % HD];
        lsum += wt * red_l[w * MAXG + g];
      }
      box_acc[i] = a;
      if (i % HD == 0) {
        box_m[rank * MAXG + g] = mx;
        box_l[rank * MAXG + g] = lsum;
      }
    }
  }
  // phase 1: the partial is in rank 0's inbox; every rank but 0 is done
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait_acquire();

  // rank 0 combines the partials of the ranks that had chunks, in rank order
  // (a rank without chunks adds exactly 0); no chunk at all writes 0
  const int nr = min(nchunks, kCluster);
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int d = i % HD;
    if (PAD && d >= hd) continue;
    float mx = kNegInf;
#pragma unroll
    for (int q_r = 0; q_r < kCluster; ++q_r)
      if (q_r < nr) mx = fmaxf(mx, inbox[q_r * MAXG + g]);
    float a = 0.f, lsum = 0.f;
#pragma unroll
    for (int q_r = 0; q_r < kCluster; ++q_r) {
      if (q_r < nr) {
        const float wt = expf(inbox[q_r * MAXG + g] - mx);
        a += wt * (q_r == 0 ? red_acc[i] : inbox[2 * kCluster * MAXG + (q_r - 1) * MAXG * HD + i]);
        lsum += wt * inbox[kCluster * MAXG + q_r * MAXG + g];
      }
    }
    out[((size_t)s * H + kvh * G + g) * hd + d] = a / (lsum == 0.f ? 1.f : lsum);
  }
}

constexpr int kMaxDevices = 64;

template <typename TQ, typename TKV, int HD, int MAXG, bool PAD>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* table,
           const int* lengths, float* out, int S, int H, int KV, int hd, int page, int pmax,
           float scale, cudaStream_t stream) {
  constexpr int bytes = Smem<TKV, HD, MAXG>::kBytes;
  auto kernel = paged_decode_kernel<TQ, TKV, HD, MAXG, PAD>;
  // shared memory above 48 KB is opted into once per device
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid(kCluster, KV, S);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool), static_cast<const TKV*>(v_pool),
      table, lengths, out, H, KV, page, pmax, scale, hd);
  return static_cast<int>(cudaGetLastError());
}

// the compiled width a head dim runs at (0: none): 64 or 128 themselves,
// else the next of them for hd % 4 == 0
__host__ __device__ constexpr int compiled_hd(int hd) {
  return hd <= 0 || hd > 128 || hd % 4 != 0 ? 0 : hd <= 64 ? 64 : 128;
}

template <typename TQ, typename TKV, int HD, bool PAD>
int launch_group(const void* q, const void* k_pool, const void* v_pool, const int* table,
                 const int* lengths, float* out, int S, int H, int KV, int hd, int page,
                 int pmax, float scale, cudaStream_t st) {
  return H / KV <= 4
             ? launch<TQ, TKV, HD, 4, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
             : launch<TQ, TKV, HD, 16, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
}

// One (q, pool) type pair at its compiled width: the native head dims (64,
// 128) when PAD is false, the padded ones (the others with hd % 4 == 0)
// when it is true; any other hd is refused.
template <typename TQ, typename TKV, bool PAD>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const int* table,
             const int* lengths, float* out, int S, int H, int KV, int hd, int page, int pmax,
             float scale, cudaStream_t st) {
  const int w = compiled_hd(hd);
  if (w == 0 || (hd != w) != PAD) return static_cast<int>(cudaErrorInvalidValue);
  return w == 64
             ? launch_group<TQ, TKV, 64, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
             : launch_group<TQ, TKV, 128, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
}

// The entry points' body: checks, then the type pair.  Returns the launch's
// cudaError_t (0 on success).  q_bf16 / kv_bf16 select bf16 (1) or fp32
// (0) for q and for the pools.
template <bool PAD>
int paged_decode_entry(const void* q, int q_bf16, const void* k_pool, const void* v_pool,
                       int kv_bf16, const int* table, const int* lengths, float* out, int S,
                       int H, int KV, int hd, int page, int pmax, float scale, void* stream) {
  if (S <= 0 || S > 65535 || KV <= 0 || KV > 65535 || H % KV != 0 || H / KV > kMaxGroup ||
      page <= 0 || pmax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16 ? dispatch<__nv_bfloat16, __nv_bfloat16, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
                   : dispatch<__nv_bfloat16, float, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
  }
  return kv_bf16 ? dispatch<float, __nv_bfloat16, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
                 : dispatch<float, float, PAD>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
}

}  // namespace
