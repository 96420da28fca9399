// Paged-attention decode for Hopper (sm_90a) at the head dims between the
// compiled ones (hd % 4 == 0, below 64 or between 64 and 128): the kernel
// of paged_decode.cuh with its lanes predicated on d < hd, the pool at its
// own stride.  A library of its own, so that it compiles beside
// paged_decode.cu.

#include "paged_decode.cuh"

extern "C" int vtt_paged_decode_pad(const void* q, int q_bf16, const void* k_pool,
                                    const void* v_pool, int kv_bf16,
                                    const int* table, const int* lengths,
                                    float* out, int S, int H, int KV, int hd,
                                    int page, int pmax, float scale, void* stream) {
  return paged_decode_entry<true>(q, q_bf16, k_pool, v_pool, kv_bf16, table, lengths, out, S,
                                  H, KV, hd, page, pmax, scale, stream);
}
