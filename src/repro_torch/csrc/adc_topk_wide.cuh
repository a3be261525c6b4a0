// The in-place block's instantiations (see adc_topk_wide.cu): B6 / B7's
// kernel at G tables a unit and B2 / B5's pair kernel, their launches and
// occupancy for every (code format, width, path) that
// REPRO_ADC_DISPATCH_WIDE names.  adc_topk_wide.cu instantiates G = 1 and
// the pair kernel, adc_topk_wide_g24.cu G = 2 and 4, so that the halves
// compile in parallel.

#pragma once

#include "adc_topk_multi.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<G>())
adc_topk_wide_kernel(const WideArgs a) {
  topk_inplace<CodeT, OFFSETS, WT, G, SORT>(a);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())
adc_topk_scan_wide_kernel(const ScanWideArgs a) {
  topk_inplace<CodeT, OFFSETS, WT, 1, SORT>(a);
}

// The kernel of an instantiation: B6 / B7's at G, or B2 / B5's (G = 1).
template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT>
auto wide_kernel_of(const WideArgs*) { return adc_topk_wide_kernel<CodeT, OFFSETS, WT, G, SORT>; }
template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT>
auto wide_kernel_of(const ScanWideArgs*) {
  static_assert(G == 1, "B2 / B5's pairs are units of one table");
  return adc_topk_scan_wide_kernel<CodeT, OFFSETS, WT, SORT>;
}

template <int G, typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
int wide_launch_g(const Args& a, int n_blocks, cudaStream_t stream) {
  return launch_multi_kernel(wide_kernel_of<CodeT, OFFSETS, WT, G, SORT>(&a), a, G, n_blocks,
                             multi_table_width<OFFSETS, WT>(a.table_width, a.w), stream);
}

template <int G, typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
int wide_blocks_per_sm_g(int table_width, int w, int k) {
  return multi_blocks_per_sm(wide_kernel_of<CodeT, OFFSETS, WT, G, SORT>(
                                 static_cast<const Args*>(nullptr)),
                             G, multi_table_width<OFFSETS, WT>(table_width, w), k, true);
}

template <int G, typename Args>
int wide_launch(const Args& a, int code_fmt, int w, int onehot, int n_blocks,
                cudaStream_t stream) {
#define REPRO_WIDE_LAUNCH(CodeT, OFF, WT, SORT) \
  wide_launch_g<G, CodeT, OFF, WT, SORT>(a, n_blocks, stream)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_WIDE_LAUNCH)
#undef REPRO_WIDE_LAUNCH
}

template <int G, typename Args>
int wide_blocks_per_sm(int code_fmt, int onehot, int w, int table_width, int k) {
#define REPRO_WIDE_OCC(CodeT, OFF, WT, SORT) \
  wide_blocks_per_sm_g<G, CodeT, OFF, WT, SORT, Args>(table_width, w, k)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_WIDE_OCC)
#undef REPRO_WIDE_OCC
}

}  // namespace

namespace repro_adc {

// the G = 2 and 4 halves, defined in adc_topk_wide_g24.cu
int adc_topk_wide_launch_g24(const WideArgs& a, int g, int code_fmt, int w, int onehot,
                             int n_blocks, cudaStream_t stream);
int adc_topk_wide_blocks_per_sm_g24(int g, int code_fmt, int onehot, int w, int table_width,
                                    int k);

}  // namespace repro_adc
