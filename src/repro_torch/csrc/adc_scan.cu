// Kernel B8: the plain ADC scan, one table over (N, W) codes -> (N,) f32.
//
// Replaces: src/repro/kernels/adc_scan.py `adc_scan_kernel`
//           (Pallas body `_adc_scan_kernel`, gather path `_gather_dists`,
//           onehot path `_onehot_dists`).
//
// The TPU kernel pins the flat table in VMEM and streams (block_n, W) tiles
// of int32 addresses past it (raw codes are widened and offset to
// m * 256 + code by the wrapper, and the rows padded to a block_n
// multiple).  Here the table sits in the shared memory of each block, and
// the blocks -- as many as fit on the card at once -- stride over the rows
// one row per thread: a row is loaded with the widest vector loads its
// width allows (`adc_row`, adc_topk_common.cuh, shared with B2/B5/B6/B7),
// raw uint8 codes get their column offset in registers (no int32 address
// array is ever written: that would be 6.4 GB at 100M rows), and the W
// table entries are added with no contraction: in column order (path
// "gather"), or in ascending address order on direct addresses (path
// "onehot": the reference's multi-hot x table contraction, which sums a
// row over the table's addresses; the row's addresses are sorted in
// registers first, `adc_row`'s SORT).  There is no padding: the last row
// is row N - 1.  The result does not depend on the caller's block_n.
//
// What bounds it on an H100: bytes.  Each row is read once (16 B at M = 16
// raw codes) and its distance written once (4 B): 2.0 GB for 100M rows,
// 0.60 ms at 3.35 TB/s.  The table is read once per block (16 KB), and the
// W lookups per row are shared-memory gathers.  A table wider than a
// block's 227 KB of shared memory (uint16 addresses reach 65,536 entries,
// 256 KB) is not staged: the GTAB instantiation reads it where it lies,
// each lookup a load through the L1 and L2, the same sums in the same
// order.

#include "adc_topk_common.cuh"

namespace {

using namespace repro_adc;

template <typename CodeT, bool OFFSETS, int WT, bool SORT, bool GTAB>
__global__ void __launch_bounds__(THREADS)
adc_scan_kernel(const float* __restrict__ table,   // (A,)
                const CodeT* __restrict__ codes,   // (N, W)
                float* __restrict__ out,           // (N,)
                long long n, int w_rt, int table_width) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tab = table;
  if constexpr (!GTAB) {
    float* staged = reinterpret_cast<float*>(smem);
    const int tw = OFFSETS && WT > 0 ? WT * NCODES : table_width;
    for (int i = threadIdx.x; i < tw; i += THREADS) staged[i] = table[i];
    __syncthreads();
    tab = staged;
  }
  const int W = WT > 0 ? WT : w_rt;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long r = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; r < n;
       r += stride)
    out[r] = adc_row<CodeT, OFFSETS, WT, SORT>(tab, codes + static_cast<size_t>(r) * W, W);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT, bool GTAB>
int launch(const float* table, const void* codes, float* out, long long n, int w,
           int table_width, cudaStream_t stream) {
  const int tw = OFFSETS && WT > 0 ? WT * NCODES : table_width;
  const size_t smem = GTAB ? 0 : static_cast<size_t>(tw) * 4;
  auto kernel = adc_scan_kernel<CodeT, OFFSETS, WT, SORT, GTAB>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(e);
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return static_cast<int>(e);
  const long long need = (n + THREADS - 1) / THREADS;
  const long long fill = static_cast<long long>(n_sm) * (per_sm > 0 ? per_sm : 1);
  const int grid = static_cast<int>(need < fill ? need : fill);
  kernel<<<grid, THREADS, smem, stream>>>(table, static_cast<const CodeT*>(codes), out, n,
                                          w, table_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (table_width,) f32; codes (n, w) in `code_fmt` (0 uint8 raw +
// column offsets, 1 uint16, 2 int32 direct addresses); onehot nonzero for
// the onehot path; gtab nonzero: the table is read from device memory
// where it lies (a table wider than a block's shared memory; the L1 and L2
// hold its hot lines), else staged in each block's shared memory; out
// (n,) f32.  Returns cudaGetLastError() after the launch.
extern "C" int adc_scan_launch(const void* table, const void* codes, void* out,
                               long long n, int w, int table_width, int code_fmt,
                               int onehot, int gtab, void* stream) {
  if (n <= 0) return 0;
#define REPRO_SCAN_ARGS                                                     \
  static_cast<const float*>(table), codes, static_cast<float*>(out), n, w, \
      table_width, static_cast<cudaStream_t>(stream)
#define REPRO_SCAN_LAUNCH(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT, false>(REPRO_SCAN_ARGS)
#define REPRO_SCAN_GTAB(CodeT, OFF, WT, SORT) launch<CodeT, OFF, WT, SORT, true>(REPRO_SCAN_ARGS)
  if (gtab) {
    REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_SCAN_GTAB)
  }
  REPRO_ADC_DISPATCH(code_fmt, w, onehot, REPRO_SCAN_LAUNCH)
#undef REPRO_SCAN_GTAB
#undef REPRO_SCAN_LAUNCH
#undef REPRO_SCAN_ARGS
}
