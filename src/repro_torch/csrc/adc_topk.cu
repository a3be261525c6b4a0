// Kernel B6: fused ADC scan + top-k of many tables over one shared code
// array (or over groups of rows, each with its own tables), with the
// per-query tile bound; one launch per call.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_kernel`
//           (Pallas bodies `_adc_topk_kernel`, `_merge_candidates`).
//
// The TPU kernel runs a (Q, N / block_n) grid in order: query q's table
// stays in VMEM while the tiles of the (N, W) codes stream past it, and a
// running top-k in VMEM scratch takes each tile whose minimum is below the
// current k-th and at most the query's bound.  Since the tiles of a query
// run in ascending rows, that is exactly: the k smallest rows by
// (distance, row) over the tiles whose own minimum is <= bound[q] (the
// `tile_min < kth` skip changes nothing in a sequential run).  Each tile's
// decision depends on that tile alone, so the result does not depend on
// the order the tiles are visited in -- but it does depend on the tile
// geometry, so the tiles here are the caller's `block_n` rows, whatever
// the CUDA block size.
//
// Here (adc_topk_multi.cuh): units of G tables (G = 4 interleaved in
// shared memory, or G = 1) over a range of rows; a grid sized from the SM
// count splits the units' tiles evenly into runs, one block scans its runs
// reading each code row once for its G tables, and the block that finishes
// a unit's last run merges the unit's run lists into the output in the same
// launch.  The wrapper (kernels/adc_topk.py `topk_plan`) picks G from the
// tables' width, k and the shared memory; a table that fits beside no list
// runs the in-place block of adc_topk_wide.cu (G = 1, 2 or 4 interleaved
// tables read where they lie) and k past 4096 the select kernels of
// adc_topk_select.cu instead.  Path: "gather" adds a row's entries in column order,
// "onehot" (direct addresses) in ascending address order, the reference's
// multi-hot contraction; the launch's `onehot` flag picks the
// instantiation.
//
// What bounds it on an H100: bytes for a few tables (each code row read
// once per unit, 16 B at M = 16: 1.6 GB for 100M rows, 0.48 ms at 3.35
// TB/s); the shared-memory table lookups for more (Q * N * W of them, at
// 2.54 SM clocks per warp-wide lookup of one table's entry interleaved by
// 4, 3.16 alone: tools/bench_smem_lookup.cu).
//
// Build: the G = 4 instantiations compile here and the G = 1 ones in
// adc_topk_g1.cu (both from adc_topk_b6.cuh), so that the two halves of
// B6's 32 kernels compile in parallel.

#include "adc_topk_b6.cuh"

// tables (n_q, table_width) f32; codes (n_rows, w) in `code_fmt` (0 uint8
// raw + column offsets, 1 uint16, 2 int32 direct addresses); bound (n_q,)
// f32 or null (+inf); onehot nonzero for the onehot path; units
// (n_units, 4) int32 {row0, n_rows, q0, nq} or
// null (one code array: ceil(n_q / g) units over all n_rows rows); out_*
// (n_q, k); part_* hold (n_blocks + n_units) * g * k scratch entries and
// tickets n_blocks + 2 * n_units int32 zeros (left zero).  Returns cudaGetLastError()
// after the launch.
extern "C" int adc_topk_launch(const void* tables, const void* codes, const void* bound,
                               const void* units, void* out_v, void* out_i, void* part_v,
                               void* part_i, void* tickets, int n_units, int n_q, int n_rows,
                               int w, int table_width, int code_fmt, int onehot, int k,
                               int block_n, int g, int n_blocks, void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  MultiArgs a{static_cast<const float*>(tables), codes, static_cast<const float*>(bound),
              static_cast<const int*>(units), nullptr, static_cast<float*>(out_v),
              static_cast<int*>(out_i), static_cast<float*>(part_v), static_cast<int*>(part_i),
              static_cast<int*>(tickets), 0, n_units, n_q, n_rows, w, table_width, k, block_n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g == 4) return b6_launch<4>(a, code_fmt, w, onehot, n_blocks, st);
  if (g == 1) return repro_adc::adc_topk_launch_g1(a, code_fmt, w, onehot, n_blocks, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM of the instantiation `adc_topk_launch` would run
// (after raising its shared-memory limit), or minus a cudaError_t.
extern "C" int adc_topk_blocks_per_sm(int code_fmt, int onehot, int w, int table_width, int k,
                                      int g) {
  if (g == 4) return b6_blocks_per_sm<4>(code_fmt, onehot, w, table_width, k);
  if (g == 1) return repro_adc::adc_topk_blocks_per_sm_g1(code_fmt, onehot, w, table_width, k);
  return -static_cast<int>(cudaErrorInvalidValue);
}
