// Kernel B6's instantiations at G tables a unit (see adc_topk.cu): the
// kernel, its launch and its occupancy for every (code format, width,
// path) that REPRO_ADC_DISPATCH names.  adc_topk.cu instantiates G = 4,
// adc_topk_g1.cu G = 1, so that the two compile in parallel.

#pragma once

#include "adc_topk_multi.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<G>())
adc_topk_kernel(const MultiArgs a) {
  topk_multi<CodeT, OFFSETS, WT, G, SORT>(a);
}

template <int G, typename CodeT, bool OFFSETS, int WT, bool SORT>
int launch_g(const MultiArgs& a, int n_blocks, cudaStream_t stream) {
  return launch_multi_kernel(adc_topk_kernel<CodeT, OFFSETS, WT, G, SORT>, a, G, n_blocks,
                             multi_table_width<OFFSETS, WT>(a.table_width, a.w), stream);
}

template <int G, typename CodeT, bool OFFSETS, int WT, bool SORT>
int blocks_per_sm_g(int table_width, int w, int k) {
  return multi_blocks_per_sm(adc_topk_kernel<CodeT, OFFSETS, WT, G, SORT>, G,
                             multi_table_width<OFFSETS, WT>(table_width, w), k);
}

template <int G>
int b6_launch(const MultiArgs& a, int code_fmt, int w, int onehot, int n_blocks,
              cudaStream_t stream) {
#define REPRO_B6_LAUNCH(CodeT, OFF, WT, SORT) launch_g<G, CodeT, OFF, WT, SORT>(a, n_blocks, stream)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_B6_LAUNCH)
#undef REPRO_B6_LAUNCH
}

template <int G>
int b6_blocks_per_sm(int code_fmt, int onehot, int w, int table_width, int k) {
#define REPRO_B6_OCC(CodeT, OFF, WT, SORT) blocks_per_sm_g<G, CodeT, OFF, WT, SORT>(table_width, w, k)
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_B6_OCC)
#undef REPRO_B6_OCC
}

}  // namespace

namespace repro_adc {

// the G = 1 half, defined in adc_topk_g1.cu
int adc_topk_launch_g1(const MultiArgs& a, int code_fmt, int w, int onehot, int n_blocks,
                       cudaStream_t stream);
int adc_topk_blocks_per_sm_g1(int code_fmt, int onehot, int w, int table_width, int k);

}  // namespace repro_adc
