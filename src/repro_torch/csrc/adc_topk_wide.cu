// Kernels B6 and B7 past their shared-memory block at k <= 4096: a table
// too wide to stage, read where it lies, one table a unit (a larger k runs
// the select kernels of adc_topk_select.cu).
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_kernel` (B6) and
//           `adc_topk_pairs_kernel` (B7), over the part of their domain
//           the blocks of adc_topk.cu / adc_topk_pairs.cu do not hold: the
//           Pallas kernels keep a table of any width in VMEM.
//
// It is the multi-table block of adc_topk_multi.cuh at G = 1 run on
// `WideArgs`: the same units, runs, passes, candidate test, merges and
// merge tree, so the same rows by (distance, row), bit-equal to the plain
// versions.  What moves (`WideArgs::gtab`, chosen by kernels/adc_topk.py
// `topk_plan`): the unit's table row is read from device memory at each
// lookup (the L1 and L2 hold its hot lines) instead of being staged in
// shared memory.  B6's and B7's units differ only in where they come from
// (`unit_at`), so one kernel serves both launchers below.
//
// What bounds it on an H100: as B6 / B7, the code bytes for few tables,
// and the table's lookups through L1.

#include "adc_topk_multi.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())
adc_topk_wide_kernel(const WideArgs a) {
  topk_multi<CodeT, OFFSETS, WT, 1, SORT>(a);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int launch(const WideArgs& a, int n_blocks, cudaStream_t stream) {
  return launch_multi_kernel(adc_topk_wide_kernel<CodeT, OFFSETS, WT, SORT>, a, 1, n_blocks,
                             multi_table_width<OFFSETS, WT>(a.table_width, a.w), stream);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
int blocks_per_sm(int table_width, int w, int k, int gtab) {
  return multi_blocks_per_sm(adc_topk_wide_kernel<CodeT, OFFSETS, WT, SORT>, 1,
                             multi_table_width<OFFSETS, WT>(table_width, w), k, gtab);
}

}  // namespace

// One launch of the WIDE block.  B6: units (n_units, 4) int32 {row0,
// n_rows, q0, nq = 1} or null (n_q units over all n_rows rows), n_valid
// null.  B7: n_valid (n_units,) int32 and win_len rows a window, units
// null.  tables (n_q, table_width) f32; codes in `code_fmt` (0 uint8 raw +
// column offsets, 1 uint16, 2 int32 direct addresses); bound (n_q,) f32 or
// null; out_* (n_q, k); part_* (n_blocks + n_units) * k scratch entries,
// tickets n_blocks + 2 * n_units int32 zeros (left zero).  Returns
// cudaGetLastError() after the launch.
extern "C" int adc_topk_wide_launch(const void* tables, const void* codes, const void* bound,
                                    const void* units, const void* n_valid, void* out_v,
                                    void* out_i, void* part_v, void* part_i, void* tickets,
                                    long long win_len, int n_units, int n_q, int n_rows, int w,
                                    int table_width, int code_fmt, int onehot, int k, int block_n,
                                    int gtab, int n_blocks, void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  WideArgs a{{static_cast<const float*>(tables), codes, static_cast<const float*>(bound),
               static_cast<const int*>(units), static_cast<const int*>(n_valid),
               static_cast<float*>(out_v), static_cast<int*>(out_i), static_cast<float*>(part_v),
               static_cast<int*>(part_i), static_cast<int*>(tickets), win_len, n_units, n_q,
               n_rows, w, table_width, k, block_n},
              gtab};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_WIDE_LAUNCH(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT>(a, n_blocks, st)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_WIDE_LAUNCH)
#undef REPRO_WIDE_LAUNCH
}

// Resident blocks per SM of the instantiation `adc_topk_wide_launch` would
// run, or minus a cudaError_t.
extern "C" int adc_topk_wide_blocks_per_sm(int code_fmt, int onehot, int w, int table_width,
                                           int k, int gtab) {
#define REPRO_WIDE_OCC(CodeT, OFF, WT, SORT) \
  blocks_per_sm<CodeT, OFF, WT, SORT>(table_width, w, k, gtab)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_WIDE_OCC)
#undef REPRO_WIDE_OCC
}
