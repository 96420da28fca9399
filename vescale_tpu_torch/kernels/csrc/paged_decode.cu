// Paged-attention decode for Hopper (sm_90a) at its compiled head dims, 64
// and 128: the kernel and its notes are in paged_decode.cuh;
// paged_decode_pad.cu builds the padded head dims.

#include "paged_decode.cuh"

extern "C" int vtt_paged_decode(const void* q, int q_bf16, const void* k_pool,
                                const void* v_pool, int kv_bf16,
                                const int* table, const int* lengths,
                                float* out, int S, int H, int KV, int hd,
                                int page, int pmax, float scale, void* stream) {
  return paged_decode_entry<false>(q, q_bf16, k_pool, v_pool, kv_bf16, table, lengths, out, S,
                                   H, KV, hd, page, pmax, scale, stream);
}

// The shared memory (bytes) and ring stages of the kernel that serves pools
// of that type, head_dim and group size G (a padded head dim: its compiled
// width's); 0 on success.
extern "C" int vtt_paged_decode_layout(int kv_bf16, int hd, int group, int* smem_bytes,
                                       int* stages) {
  if (group <= 0 || group > kMaxGroup) return static_cast<int>(cudaErrorInvalidValue);
  const bool small = group <= 4;
  hd = compiled_hd(hd);
#define VTT_LAYOUT(T, D)                                                          \
  do {                                                                            \
    *smem_bytes = small ? Smem<T, D, 4>::kBytes : Smem<T, D, 16>::kBytes;         \
    *stages = small ? Smem<T, D, 4>::kStages : Smem<T, D, 16>::kStages;           \
    return 0;                                                                     \
  } while (0)
  if (hd == 64) {
    if (kv_bf16) VTT_LAYOUT(__nv_bfloat16, 64);
    VTT_LAYOUT(float, 64);
  }
  if (hd == 128) {
    if (kv_bf16) VTT_LAYOUT(__nv_bfloat16, 128);
    VTT_LAYOUT(float, 128);
  }
#undef VTT_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}
