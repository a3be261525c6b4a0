// Kernel B10's general kernel (flash_attn.cuh `flash_fwd_general_kernel`),
// the instances of two, four or eight warps a row tile (head dims past 128), and every
// instance with element copies: compiled apart from the fast
// kernel's source so that the sources build in parallel.

#include "flash_attn.cuh"

namespace repro_flash {

int general_part1(const void* q, const void* k, const void* v, void* out, int b, int sq,
                  int sk, int h, int kvh, int hd, int q_offset, int kv_valid, int q_is_bf16,
                  int kv_is_bf16, float scale, bool elem, cudaStream_t stream, int* attrs) {
  return general_part<1>(q, k, v, out, b, sq, sk, h, kvh, hd, q_offset, kv_valid,
                          q_is_bf16, kv_is_bf16, scale, elem, stream, attrs);
}

}  // namespace repro_flash
