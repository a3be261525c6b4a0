// Kernel B6 (adc_topk.cu) at G = 1 table a unit: its instantiations
// compile here, beside the G = 4 ones in adc_topk.cu.

#include "adc_topk_b6.cuh"

namespace repro_adc {

int adc_topk_launch_g1(const MultiArgs& a, int code_fmt, int w, int onehot, int n_blocks,
                       cudaStream_t stream) {
  return b6_launch<1>(a, code_fmt, w, onehot, n_blocks, stream);
}

int adc_topk_blocks_per_sm_g1(int code_fmt, int onehot, int w, int table_width, int k) {
  return b6_blocks_per_sm<1>(code_fmt, onehot, w, table_width, k);
}

}  // namespace repro_adc
