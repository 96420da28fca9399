// Paged-attention decode for Hopper (sm_90a).
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
// Design.  The TPU grid (S, Pmax) ran in order and carried the softmax state
// across a slot's pages in scratch memory.  Here one CTA of 512 threads per
// (slot, kv head) walks that slot's positions in order, 64 at a time
// (several pages, each page id loaded from the table inside the kernel),
// and keeps the running (m, l) of its G query heads in shared memory.
// Scores: each of the 16 warps loads the K and V rows of 4 positions at
// once (V goes to shared memory) and reduces each dot over hd with
// shuffles.  P.V: thread (part, d) owns column d of every head and sums the
// positions part, part + NPART, ... of each pass in order; the NPART
// partial sums are added in part order at the end.  No atomics and no
// data-dependent split, so a slot's output depends only on its own K/V and
// length, and is the same from run to run: greedy replay stays
// bit-identical.
//
// Bound: the bytes of K/V the slots hold, S * len * KV * hd * 2 * bytes,
// read once, against the card's memory bandwidth.  This first kernel has
// only S * KV CTAs, and the longest slot's CTA walks all its positions
// alone; a fixed split of long slots over several CTAs (combined in a fixed
// order, so still deterministic) and cp.async or TMA pipelining are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;                 // positions a warp loads at once
constexpr int kChunk = kWarps * kPerWarp;   // positions per pass
constexpr int kMaxGroup = 16;               // q heads per kv head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
    const TKV* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ out, int H, int KV,
    int page, int pmax, float scale) {
  constexpr int EPL = HD / 32;          // elements of a row per lane
  constexpr int NPART = kThreads / HD;  // threads sharing one output column
  // the pass's V rows, and at the end the NPART partial sums
  constexpr int kBuf = NPART * kMaxGroup > kChunk ? NPART * kMaxGroup * HD : kChunk * HD;
  static_assert(HD % 32 == 0 && kThreads % HD == 0, "unsupported head_dim");

  __shared__ float q_s[kMaxGroup][HD];
  __shared__ float p_s[kMaxGroup][kChunk];
  __shared__ float v_s[kBuf];  // [kChunk][HD] V rows; then [NPART][kMaxGroup][HD]
  __shared__ long long row_s[kChunk];  // element offset of a position's row
  __shared__ float m_s[kMaxGroup];
  __shared__ float l_s[kMaxGroup];
  __shared__ float alpha_s[kMaxGroup];

  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = tid % HD;     // this thread's output column
  const int part = tid / HD;  // ... over positions part, part + NPART, ...

  // the kv group's q rows, scaled before the dot as the TPU kernel does
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int c = i % HD;
    q_s[g][c] = to_float(q[((size_t)s * H + kvh * G + g) * HD + c]) * scale;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  // positions past the table's reach are masked, as in the TPU kernel
  const int len = max(0, min(lengths[s], page * pmax));
  __syncthreads();

  for (int base = 0; base < len; base += kChunk) {
    const int n = min(kChunk, len - base);
    for (int t = tid; t < n; t += kThreads) {
      const int pos = base + t;
      const long long pg = table[(size_t)s * pmax + pos / page];
      row_s[t] = ((pg * page + pos % page) * KV + kvh) * HD;
    }
    __syncthreads();

    // scores, with the V rows staged in shared memory: warp w loads the K
    // and V rows of positions w*kPerWarp .. +kPerWarp-1 at once (many loads
    // in flight), then reduces each position's dots with shuffles
    {
      const int t0 = warp * kPerWarp;
      float kr[kPerWarp][EPL], vr[kPerWarp][EPL];
#pragma unroll
      for (int p = 0; p < kPerWarp; ++p) {
        const int t = t0 + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kr[p][e] = t < n ? to_float(k_pool[row_s[t] + lane + 32 * e]) : 0.f;
          vr[p][e] = t < n ? to_float(v_pool[row_s[t] + lane + 32 * e]) : 0.f;
        }
      }
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int p = 0; p < kPerWarp; ++p) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += q_s[g][lane + 32 * e] * kr[p][e];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          if (lane == 0 && t0 + p < n) p_s[g][t0 + p] = dot;
        }
      }
#pragma unroll
      for (int p = 0; p < kPerWarp; ++p) {
        if (t0 + p < n) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) v_s[(t0 + p) * HD + lane + 32 * e] = vr[p][e];
        }
      }
    }
    __syncthreads();

    // online softmax: warp g takes head g
    if (warp < G) {
      const int g = warp;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, p_s[g][t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        // a NaN score (NaN K at a valid position) stays NaN here and
        // poisons l and acc of its head, as in the reference
        const float p = expf(p_s[g][t] - m_new);
        p_s[g][t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this thread's positions, in order
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < G) acc[g] *= alpha_s[g];
#pragma unroll 4
    for (int t = part; t < n; t += NPART) {
      const float vv = v_s[t * HD + d];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] += p_s[g][t] * vv;
    }
    __syncthreads();  // row_s, p_s and v_s are rewritten by the next pass
  }

  // add the NPART partial sums in part order
  float* red = v_s;
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < G) red[(part * kMaxGroup + g) * HD + d] = acc[g];
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD;
    const int c = i % HD;
    float total = red[g * HD + c];
    for (int pt = 1; pt < NPART; ++pt) total += red[(pt * kMaxGroup + g) * HD + c];
    const float l = l_s[g];
    out[((size_t)s * H + kvh * G + g) * HD + c] = total / (l == 0.f ? 1.f : l);
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* table, const int* lengths, float* out, int S, int H,
           int KV, int hd, int page, int pmax, float scale, cudaStream_t stream) {
  const dim3 grid(S, KV);
  const TQ* qt = static_cast<const TQ*>(q);
  const TKV* kt = static_cast<const TKV*>(k_pool);
  const TKV* vt = static_cast<const TKV*>(v_pool);
  switch (hd) {
    case 64:
      paged_decode_kernel<TQ, TKV, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, table, lengths, out, H, KV, page, pmax, scale);
      break;
    case 128:
      paged_decode_kernel<TQ, TKV, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, table, lengths, out, H, KV, page, pmax, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the launch's cudaError_t (0 on success).  q_bf16 / kv_bf16 select
// bf16 (1) or fp32 (0) for q and for the pools.
extern "C" int vtt_paged_decode(const void* q, int q_bf16, const void* k_pool,
                                const void* v_pool, int kv_bf16,
                                const int* table, const int* lengths,
                                float* out, int S, int H, int KV, int hd,
                                int page, int pmax, float scale, void* stream) {
  if (S <= 0 || KV <= 0 || H % KV != 0 || H / KV > kMaxGroup || page <= 0 || pmax <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
                   : launch<__nv_bfloat16, float>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
  }
  return kv_bf16 ? launch<float, __nv_bfloat16>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st)
                 : launch<float, float>(q, k_pool, v_pool, table, lengths, out, S, H, KV, hd, page, pmax, scale, st);
}
