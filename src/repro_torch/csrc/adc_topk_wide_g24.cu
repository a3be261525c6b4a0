// The in-place block (adc_topk_wide.cu) at G = 2 and 4 interleaved tables
// a unit: its instantiations compile here, beside the G = 1 and B2 / B5
// ones in adc_topk_wide.cu.

#include "adc_topk_wide.cuh"

namespace repro_adc {

int adc_topk_wide_launch_g24(const WideArgs& a, int g, int code_fmt, int w, int onehot,
                             int n_blocks, cudaStream_t stream) {
  if (g == 4) return wide_launch<4>(a, code_fmt, w, onehot, n_blocks, stream);
  if (g == 2) return wide_launch<2>(a, code_fmt, w, onehot, n_blocks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int adc_topk_wide_blocks_per_sm_g24(int g, int code_fmt, int onehot, int w, int table_width,
                                    int k) {
  if (g == 4) return wide_blocks_per_sm<4, WideArgs>(code_fmt, onehot, w, table_width, k);
  if (g == 2) return wide_blocks_per_sm<2, WideArgs>(code_fmt, onehot, w, table_width, k);
  return -static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro_adc
