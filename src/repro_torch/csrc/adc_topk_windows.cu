// Kernel B5: fused ADC scan + running per-pair top-k over per-pair windows
// of the shared code array, with the exact whole-tile pruning.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_windows_kernel`
//           (Pallas body `_adc_topk_windows_kernel`).
//
// The TPU kernel runs a (pairs, window / block_n) grid: every pair visits
// every tile of a window as wide as the largest cluster (259,072 rows at
// 100M rows, against a median cluster of ~24k), with the streamed block
// index clamped at the last block so a window running past the end of the
// codes re-reads it (rows the n_valid mask drops).  A tile holding no valid
// row can neither change a pair's list nor count as skipped (the reference
// counts a skipped tile only when it holds valid rows), so here one block
// runs one FILLED pair (a table and n_valid > 0) and loops over the blocks
// 0 .. ceil(n_valid / block_n) - 1 of its window from slot_start, never over
// the padding: its outputs and skip counters are those of the TPU kernel
// run in this pair order, and no clamp is needed (a slot's valid blocks lie
// inside the codes).  Skip rule, merge and the shared query bound `sq` are
// B2's (`scan_pair`, adc_topk_common.cuh), for raw uint8 codes with column
// offsets or uint16 / int32 direct addresses.  The wrapper launches the
// filled pairs best-first (ascending lower bound), so `sq` tightens early;
// the merged per-query output does not depend on the order; a table too
// wide for shared memory runs the in-place block of adc_topk_wide.cu (each
// pair's window tiles cut over the grid) and k past 4096 the select
// kernels, as B2's do.  Path: as B2
// ("gather" column order, "onehot" ascending address order, `onehot`).
//
// What bounds it on an H100: as B2, not bytes but the shared memory's
// issue of the table lookups (adc_topk_tiles.cu says why); each valid
// probed row that is not pruned is read once, and no tile queue is built
// or shipped.

#include "adc_topk_common.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, scan_min_blocks<CodeT, SORT>())
adc_topk_windows_kernel(const float* __restrict__ tables,     // (R, A)
                        const int* __restrict__ lut_row,      // (P_all,)
                        const CodeT* __restrict__ codes,      // (ndev, cap, W)
                        const int* __restrict__ pair_order,   // (n_blocks,)
                        const int* __restrict__ starts,       // (P_all,) rows
                        const int* __restrict__ n_valid,      // (P_all,)
                        const int* __restrict__ pair_q,       // (P_all,)
                        const float* __restrict__ pair_lb,    // (P_all,)
                        const float* __restrict__ bound,      // (Q,)
                        float* sq,                            // (Q,) shared
                        float* __restrict__ out_v,            // (P_all, k)
                        int* __restrict__ out_i,              // (P_all, k)
                        int* __restrict__ stats,              // (P_all, 2)
                        int n_blocks, int pairs_per_dev, long long cap, int w_rt,
                        int table_width, int k, int block_n) {
  auto run = [&](int j) {
    const int pair = pair_order[j];
    const int row = lut_row[pair];
    const int nv = n_valid[pair];
    if (row < 0 || nv <= 0) return;
    const int W = WT > 0 ? WT : w_rt;
    const int qi = pair_q[pair];
    const int start_blk = starts[pair] / block_n;  // slots are block-aligned
    const CodeT* cdev = codes + static_cast<size_t>(pair / pairs_per_dev) * cap * W;
    auto tile_at = [&](int t) { return TileRef{t * block_n, start_blk + t}; };
    scan_pair<CodeT, OFFSETS, WT, SORT>(
        tables + static_cast<size_t>(row) * table_width, table_width, cdev, W,
        (nv + block_n - 1) / block_n, tile_at, nv, qi, pair_lb[pair], bound[qi],
        sq, k, block_n, out_v + static_cast<size_t>(pair) * k,
        out_i + static_cast<size_t>(pair) * k, stats + 2 * static_cast<size_t>(pair));
  };
  run(blockIdx.x);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int launch(const float* tables, const int* lut_row, const void* codes,
           const int* order, const int* starts, const int* n_valid,
           const int* pair_q, const float* pair_lb, const float* bound,
           float* sq, float* out_v, int* out_i, int* stats, int n_blocks,
           int pairs_per_dev, long long cap, int w, int table_width, int k,
           int block_n, cudaStream_t stream) {
  auto kernel = adc_topk_windows_kernel<CodeT, OFFSETS, WT, SORT>;
  const size_t smem = scan_smem_bytes(table_width, k);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, THREADS, smem, stream>>>(
      tables, lut_row, static_cast<const CodeT*>(codes), order, starts, n_valid,
      pair_q, pair_lb, bound, sq, out_v, out_i, stats, n_blocks, pairs_per_dev, cap, w,
      table_width, k, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_blocks: number of entries of pair_order (the filled pairs).  code_fmt
// and onehot as adc_topk_tiles_launch.  Returns cudaGetLastError() after
// the launch.
extern "C" int adc_topk_windows_launch(
    const void* tables, const void* lut_row, const void* codes,
    const void* pair_order, const void* starts, const void* n_valid,
    const void* pair_q, const void* pair_lb, const void* bound, void* sq,
    void* out_v, void* out_i, void* stats, int n_blocks, int pairs_per_dev,
    long long cap, int w, int table_width, int code_fmt, int onehot, int k,
    int block_n, void* stream) {
  if (n_blocks <= 0) return 0;
#define REPRO_WINDOWS_ARGS                                                   \
      static_cast<const float*>(tables), static_cast<const int*>(lut_row),   \
      codes, static_cast<const int*>(pair_order),                            \
      static_cast<const int*>(starts), static_cast<const int*>(n_valid),     \
      static_cast<const int*>(pair_q), static_cast<const float*>(pair_lb),   \
      static_cast<const float*>(bound), static_cast<float*>(sq),             \
      static_cast<float*>(out_v), static_cast<int*>(out_i),                  \
      static_cast<int*>(stats), n_blocks, pairs_per_dev, cap, w, table_width, \
      k, block_n, static_cast<cudaStream_t>(stream)
#define REPRO_WINDOWS_LAUNCH(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT>(REPRO_WINDOWS_ARGS)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_WINDOWS_LAUNCH)
#undef REPRO_WINDOWS_LAUNCH
#undef REPRO_WINDOWS_ARGS
}
