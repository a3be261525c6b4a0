// Kernel B7: fused ADC scan + per-pair top-k over materialised per-pair
// windows; one launch per call.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_pairs_kernel`
//           (Pallas bodies `_adc_topk_pairs_kernel`, `_merge_candidates`).
//
// The TPU kernel runs a (P, L / block_n) grid in order: pair p's table sits
// in VMEM while the tiles of its own (L, W) window stream past it, rows at
// or past n_valid[p] masked to +inf, and a tile is merged into the running
// top-k only when its minimum is below the current k-th -- a skip that
// changes nothing in a sequential run.  So each pair's output is the k
// smallest of its valid rows by (distance, row).
//
// Here each pair is one unit of B6's multi-table block with one table
// (adc_topk_multi.cuh): its valid tiles 0 .. ceil(n_valid / block_n) - 1,
// n_valid read on the card, are concatenated over the pairs and cut evenly
// into runs over a grid sized from the SM count, so one long window is
// walked by many blocks and many short ones share a block; the block that
// finishes a pair's last run merges the pair's run lists in the same
// launch.  A pair with n_valid = 0 has no tiles and keeps the (+inf, -1)
// the wrapper filled in.  The padding rows of a window past n_valid are
// never read, so they may hold anything.  Path: as B6 ("gather" column
// order, "onehot" ascending address order, `onehot`).
//
// What bounds it on an H100: bytes.  Each valid window row is read once
// (4W B of int32 addresses, 2W B of uint16); the W lookups per row are
// shared-memory gathers (3.16 SM clocks per warp-wide lookup,
// tools/bench_smem_lookup.cu).

#include "adc_topk_multi.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())
adc_topk_pairs_kernel(const MultiArgs a) {
  topk_multi<CodeT, OFFSETS, WT, 1, SORT>(a);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int launch(const MultiArgs& a, int n_blocks, cudaStream_t stream) {
  return launch_multi_kernel(adc_topk_pairs_kernel<CodeT, OFFSETS, WT, SORT>, a, 1, n_blocks,
                             multi_table_width<OFFSETS, WT>(a.table_width, a.w), stream);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int blocks_per_sm(int table_width, int w, int k) {
  return multi_blocks_per_sm(adc_topk_pairs_kernel<CodeT, OFFSETS, WT, SORT>, 1,
                             multi_table_width<OFFSETS, WT>(table_width, w), k);
}

}  // namespace

// tables (P, table_width) f32; addrs (P, win_len, w) uint16 (code_fmt 1)
// or int32 (2) direct addresses; onehot nonzero for the onehot path;
// n_valid (P,) int32; out_* (P, k); part_*
// hold (n_blocks + P) * k scratch entries and tickets n_blocks + 2P int32
// zeros (left zero).  Returns cudaGetLastError() after the launch.
extern "C" int adc_topk_pairs_launch(const void* tables, const void* addrs, const void* n_valid,
                                     void* out_v, void* out_i, void* part_v, void* part_i,
                                     void* tickets, int n_pairs, long long win_len, int w,
                                     int table_width, int code_fmt, int onehot, int k,
                                     int block_n, int n_blocks, void* stream) {
  if (n_pairs <= 0 || n_blocks <= 0) return 0;
  MultiArgs a{static_cast<const float*>(tables), addrs, nullptr, nullptr,
              static_cast<const int*>(n_valid), static_cast<float*>(out_v),
              static_cast<int*>(out_i), static_cast<float*>(part_v), static_cast<int*>(part_i),
              static_cast<int*>(tickets), win_len, n_pairs, n_pairs, 0, w, table_width, k,
              block_n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PAIRS_LAUNCH(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT>(a, n_blocks, st)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_PAIRS_LAUNCH)
#undef REPRO_PAIRS_LAUNCH
}

// Resident blocks per SM of the instantiation `adc_topk_pairs_launch` would
// run, or minus a cudaError_t.
extern "C" int adc_topk_pairs_blocks_per_sm(int code_fmt, int onehot, int w, int table_width,
                                            int k) {
#define REPRO_PAIRS_OCC(CodeT, OFF, WT, SORT) \
  blocks_per_sm<CodeT, OFF, WT, SORT>(table_width, w, k)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_PAIRS_OCC)
#undef REPRO_PAIRS_OCC
}
