// Kernel B2: fused ADC scan + running per-pair top-k over the tile queue,
// with the exact whole-tile pruning of early-pruning v2.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_tiles_kernel`
//           (Pallas bodies `_adc_topk_tiles_kernel`, `_merge_candidates`).
//
// The TPU kernel walks the flat tile queue as one sequential grid and keeps
// every pair's running top-k and every query's running bound `sq` in VMEM
// scratch across grid steps.  Blocks of a GPU grid run in parallel and in no
// order, so this kernel gives each pair RUN its own block: `emit_tiles`
// keeps a pair's tiles contiguous and in ascending rows, so the wrapper
// (kernels/adc_topk.py) computes each pair's tile range [t0, t1) and a
// launch order, and the block loops over the run's tiles.  Within a block
// (`scan_pair`, adc_topk_common.cuh, shared with the windows scan B5):
//
//   * the pair's table (row lut_row[pair] of the (R, A) tables: A = M*256
//     for raw codes, M*256 + n_combos + 1 for direct addresses; 16 KB or
//     17 KB at M = 16) lives in shared memory (a pair without a table, -1,
//     is not scanned);
//   * each tile's rows stream from device memory, one 16-byte load per row
//     for M = 16 raw uint8 codes, two for W = 16 uint16 addresses,
//     ROWS_PER_THREAD rows per thread in flight;
//   * the running top-k sits in shared memory, ascending by (distance, row);
//     a pass bitonic-sorts the kept rows and merges them by merge path;
//   * `sq[q]` is shared by all the query's blocks through atomicMin.
//
// Path: "gather" adds a row's entries in column order, "onehot" (direct
// addresses) in ascending address order, the reference's multi-hot
// contraction (`adc_row`'s SORT, adc_topk_common.cuh); the launch's
// `onehot` flag picks the instantiation.
//
// A table too wide for shared memory (k <= 4096: a uint16 address space of
// 65,536 entries) runs the in-place block of adc_topk_wide.cu instead: the
// pairs become units of the multi-table block, each pair's tiles cut over
// the whole grid (one block a pair would leave a few long pairs on a few
// of the card's blocks), each run skipping against its own list's k-th,
// the runs' lists merged by its ticket tree.  Past k = 4096 the wrapper runs
// the select kernels of adc_topk_select.cu (kernels/adc_topk.py
// `scan_plan` picks the block).
//
// The per-pair tails past the k-th and the (P, 2) skip counters depend on
// the launch order and differ from the TPU's; the merged per-query output
// does not (adc_topk_common.cuh states why).
//
// What bounds it on an H100.  Not bytes: each probed valid row is read
// once per pair (16 B for raw codes at M = 16, 2W B for uint16 addresses),
// mostly from L2, since a cluster is probed by many queries' pairs, and
// pruned tiles are never read.  It is bound by the shared memory's issue
// of the W table lookups per row: a warp's 32 lookups of one sub-space
// fall in random banks (code mod 32), ~2.2 SM clocks per warp lookup
// measured alone against ~1.75 for 32 distinct banks
// (tools/bench_smem_lookup.cu), ~3.2 in the whole scan.  A layout with
// lane-private table banks and a row sum passed along a chain of lanes
// removes the conflicts but pays a shuffle, a code load and a vote per
// step; it measured 2.1x slower than this design (PERF.md §6).

#include "adc_topk_common.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, scan_min_blocks<CodeT, SORT>())
adc_topk_tiles_kernel(const float* __restrict__ tables,     // (R, A)
                      const int* __restrict__ lut_row,      // (P_all,)
                      const CodeT* __restrict__ codes,      // (ndev, cap, W)
                      const int* __restrict__ pair_order,   // (P_all,)
                      const int* __restrict__ pair_t0,      // (P_all,)
                      const int* __restrict__ pair_t1,      // (P_all,)
                      const int* __restrict__ tile_block,   // (ndev*T,)
                      const int* __restrict__ tile_row0,    // (ndev*T,)
                      const int* __restrict__ n_valid,      // (P_all,)
                      const int* __restrict__ pair_q,       // (P_all,)
                      const float* __restrict__ pair_lb,    // (P_all,)
                      const float* __restrict__ bound,      // (Q,)
                      float* sq,                            // (Q,) shared
                      float* __restrict__ out_v,            // (P_all, k)
                      int* __restrict__ out_i,              // (P_all, k)
                      int* __restrict__ stats,              // (P_all, 2)
                      int n_pairs, int pairs_per_dev, long long cap, int w_rt,
                      int table_width, int k, int block_n) {
  auto run = [&](int j) {
    const int pair = pair_order[j];
    const int t0 = pair_t0[pair];
    const int t1 = pair_t1[pair];
    const int row = lut_row[pair];
    if (t0 >= t1 || row < 0) return;  // no tiles, or no table
    const int W = WT > 0 ? WT : w_rt;
    const int qi = pair_q[pair];
    const CodeT* cdev = codes + static_cast<size_t>(pair / pairs_per_dev) * cap * W;
    auto tile_at = [&](int t) {
      return TileRef{tile_row0[t0 + t], tile_block[t0 + t]};
    };
    scan_pair<CodeT, OFFSETS, WT, SORT>(
        tables + static_cast<size_t>(row) * table_width, table_width, cdev, W,
        t1 - t0, tile_at, n_valid[pair], qi, pair_lb[pair], bound[qi], sq, k,
        block_n, out_v + static_cast<size_t>(pair) * k,
        out_i + static_cast<size_t>(pair) * k, stats + 2 * static_cast<size_t>(pair));
  };
  run(blockIdx.x);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int launch(const float* tables, const int* lut_row, const void* codes,
           const int* order, const int* t0, const int* t1, const int* tile_block,
           const int* tile_row0, const int* n_valid, const int* pair_q,
           const float* pair_lb, const float* bound, float* sq, float* out_v,
           int* out_i, int* stats, int n_pairs, int pairs_per_dev,
           long long cap, int w, int table_width, int k, int block_n,
           cudaStream_t stream) {
  auto kernel = adc_topk_tiles_kernel<CodeT, OFFSETS, WT, SORT>;
  const size_t smem = scan_smem_bytes(table_width, k);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_pairs, THREADS, smem, stream>>>(
      tables, lut_row, static_cast<const CodeT*>(codes), order, t0, t1,
      tile_block, tile_row0, n_valid, pair_q, pair_lb, bound, sq, out_v,
      out_i, stats, n_pairs, pairs_per_dev, cap, w, table_width, k, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// code_fmt: 0 = uint8 raw codes (+ column offsets), 1 = uint16 direct
// addresses, 2 = int32 direct addresses; onehot: nonzero for the onehot
// path.  The shared-memory block, one per pair.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int adc_topk_tiles_launch(
    const void* tables, const void* lut_row, const void* codes,
    const void* pair_order, const void* pair_t0, const void* pair_t1,
    const void* tile_block, const void* tile_row0, const void* n_valid,
    const void* pair_q, const void* pair_lb, const void* bound, void* sq,
    void* out_v, void* out_i, void* stats, int n_pairs, int pairs_per_dev,
    long long cap, int w, int table_width, int code_fmt, int onehot, int k,
    int block_n, void* stream) {
  if (n_pairs <= 0) return 0;
#define REPRO_TILES_ARGS                                                        \
      static_cast<const float*>(tables), static_cast<const int*>(lut_row),    \
      codes, static_cast<const int*>(pair_order),                             \
      static_cast<const int*>(pair_t0), static_cast<const int*>(pair_t1),     \
      static_cast<const int*>(tile_block), static_cast<const int*>(tile_row0), \
      static_cast<const int*>(n_valid), static_cast<const int*>(pair_q),      \
      static_cast<const float*>(pair_lb), static_cast<const float*>(bound),   \
      static_cast<float*>(sq), static_cast<float*>(out_v),                    \
      static_cast<int*>(out_i), static_cast<int*>(stats), n_pairs,            \
      pairs_per_dev, cap, w, table_width, k, block_n,                         \
      static_cast<cudaStream_t>(stream)
#define REPRO_TILES_LAUNCH(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT>(REPRO_TILES_ARGS)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_TILES_LAUNCH)
#undef REPRO_TILES_LAUNCH
#undef REPRO_TILES_ARGS
}
