// Kernel B7: fused ADC scan + per-pair top-k over materialised per-pair
// windows, with the §4.4 merge pruning.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_pairs_kernel`
//           (Pallas bodies `_adc_topk_pairs_kernel`, `_merge_candidates`).
//
// The TPU kernel runs a (P, L / block_n) grid in order: pair p's table sits
// in VMEM while the tiles of its own (L, W) window stream past it, rows at
// or past n_valid[p] masked to +inf, and a tile is merged into the running
// top-k only when its minimum is below the current k-th -- a skip that
// changes nothing in a sequential run.  So each pair's output is the k
// smallest of its valid rows by (distance, row).  Here one block runs one
// pair (`scan_range_topk`, adc_topk_common.cuh, shared with B6): its table
// in shared memory, its valid tiles 0 .. ceil(n_valid / block_n) - 1 scored
// and merged as in B2/B5.  The padding rows of a window past n_valid are
// never read, so they may hold anything.
//
// What bounds it on an H100: bytes.  Each valid window row is read once
// (4W B of int32 addresses, 2W B of uint16); the W lookups per row are
// shared-memory gathers.

#include "adc_topk_common.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT>
__global__ void __launch_bounds__(THREADS, scan_min_blocks<CodeT>())
adc_topk_pairs_kernel(const float* __restrict__ tables,  // (P, A)
                      const CodeT* __restrict__ addrs,   // (P, L, W)
                      const int* __restrict__ n_valid,   // (P,)
                      float* __restrict__ out_v,         // (P, k)
                      int* __restrict__ out_i,           // (P, k)
                      long long win_len, int w_rt, int table_width, int k,
                      int block_n) {
  const int p = blockIdx.x;
  const int W = WT > 0 ? WT : w_rt;
  const int nv = static_cast<int>(
      min(static_cast<long long>(max(n_valid[p], 0)), win_len));
  scan_range_topk<CodeT, OFFSETS, WT>(
      tables + static_cast<size_t>(p) * table_width, table_width,
      addrs + static_cast<size_t>(p) * win_len * W, W, 0,
      (nv + block_n - 1) / block_n, nv, block_n, CUDART_INF_F, k,
      out_v + static_cast<size_t>(p) * k, out_i + static_cast<size_t>(p) * k);
}

template <typename CodeT, bool OFFSETS, int WT>
int launch(const float* tables, const void* addrs, const int* n_valid, float* out_v,
           int* out_i, int n_pairs, long long win_len, int w, int table_width, int k,
           int block_n, cudaStream_t stream) {
  const int tw = OFFSETS && WT > 0 ? WT * NCODES : table_width;
  const size_t smem = scan_smem_bytes(tw, k);
  cudaError_t e = allow_smem(adc_topk_pairs_kernel<CodeT, OFFSETS, WT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adc_topk_pairs_kernel<CodeT, OFFSETS, WT><<<n_pairs, THREADS, smem, stream>>>(
      tables, static_cast<const CodeT*>(addrs), n_valid, out_v, out_i, win_len, w,
      table_width, k, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables (P, table_width) f32; addrs (P, win_len, w) uint16 (code_fmt 1)
// or int32 (2) direct addresses; n_valid (P,) int32; out_* (P, k).
// Returns cudaGetLastError() after the launch.
extern "C" int adc_topk_pairs_launch(const void* tables, const void* addrs,
                                     const void* n_valid, void* out_v, void* out_i,
                                     int n_pairs, long long win_len, int w,
                                     int table_width, int code_fmt, int k,
                                     int block_n, void* stream) {
  if (n_pairs <= 0) return 0;
#define REPRO_PAIRS_LAUNCH(CodeT, OFF, WT)                                        \
  launch<CodeT, OFF, WT>(static_cast<const float*>(tables), addrs,               \
                         static_cast<const int*>(n_valid),                       \
                         static_cast<float*>(out_v), static_cast<int*>(out_i),   \
                         n_pairs, win_len, w, table_width, k, block_n,           \
                         static_cast<cudaStream_t>(stream))
  REPRO_ADC_DISPATCH(code_fmt, w, REPRO_PAIRS_LAUNCH)
#undef REPRO_PAIRS_LAUNCH
}
