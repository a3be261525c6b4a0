// Kernel B6: fused ADC scan + top-k of many tables over one shared code
// array, with the per-query tile bound.
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
// GPU blocks run in no order, so the grid is split in two passes:
//   1. scan: one block per (split, query) takes a contiguous run of
//      `tiles_per_split` tiles (`scan_range_topk`, adc_topk_common.cuh:
//      table in shared memory, rows scored and merged as in B2/B5) and
//      writes that range's top-k to a (Q, S, k) scratch list.  Blocks are
//      numbered split-major, so the Q blocks of one split run together and
//      read its codes from device memory once, from L2 after that;
//   2. reduce: one block per (query, group of FAN lists) merges its lists
//      into one by (distance, row) with the same shared-memory merge,
//      repeated until one list per query remains (S = 2048 lists take
//      three levels).
// A row is in at most one split, so the (distance, row) keys are unique
// and the merged list is the same whatever the split count.
//
// What bounds it on an H100: bytes for a few tables (each code row read
// once, 16 B at M = 16: 1.6 GB for 100M rows, 0.48 ms at 3.35 TB/s), the
// table lookups when Q is large (Q * N * W shared-memory gathers and adds).
// The split-major order keeps the bytes at one pass over the codes.

#include "adc_topk_common.cuh"

namespace {

using namespace repro_adc;

constexpr int FAN = 32;  // lists merged per reduce block

template <typename CodeT, bool OFFSETS, int WT>
__global__ void __launch_bounds__(THREADS, scan_min_blocks<CodeT>())
adc_topk_scan_kernel(const float* __restrict__ tables,  // (Q, A)
                     const CodeT* __restrict__ codes,   // (N, W)
                     const float* __restrict__ bound,   // (Q,) or null
                     float* __restrict__ part_v,        // (Q, S, k)
                     int* __restrict__ part_i,          // (Q, S, k)
                     int n_q, int n_splits, int tiles_per_split, int n_rows,
                     int w_rt, int table_width, int k, int block_n) {
  const int q = blockIdx.x % n_q;
  const int s = blockIdx.x / n_q;
  const int n_tiles = (n_rows + block_n - 1) / block_n;
  const int t0 = s * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, n_tiles);
  const size_t slot = (static_cast<size_t>(q) * n_splits + s) * k;
  scan_range_topk<CodeT, OFFSETS, WT>(
      tables + static_cast<size_t>(q) * table_width, table_width, codes,
      WT > 0 ? WT : w_rt, t0, t1, n_rows, block_n,
      bound == nullptr ? CUDART_INF_F : bound[q], k, part_v + slot, part_i + slot);
}

// Merge lists [g * FAN, min((g + 1) * FAN, n_lists)) of query q (each k
// long, ascending by (distance, row), (+inf, -1) in empty lanes) into one.
__global__ void __launch_bounds__(THREADS)
adc_topk_reduce_kernel(const float* __restrict__ in_v, const int* __restrict__ in_i,
                       float* __restrict__ out_v, int* __restrict__ out_i,
                       int n_lists, int n_out, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* top_v = reinterpret_cast<float*>(smem);
  int* top_i = reinterpret_cast<int*>(top_v + k);
  float* nxt_v = reinterpret_cast<float*>(top_i + k);
  int* nxt_i = reinterpret_cast<int*>(nxt_v + k);
  float* cand_v = reinterpret_cast<float*>(nxt_i + k);
  int* cand_i = reinterpret_cast<int*>(cand_v + PASS);
  __shared__ int s_ncand;

  const int tid = threadIdx.x;
  const int q = blockIdx.x / n_out;
  const int g = blockIdx.x % n_out;
  const int l0 = g * FAN;
  const int l1 = min(l0 + FAN, n_lists);
  const size_t base = (static_cast<size_t>(q) * n_lists + l0) * k;
  const int total = (l1 - l0) * k;
  for (int i = tid; i < k; i += THREADS) {
    top_v[i] = CUDART_INF_F;
    top_i[i] = -1;
  }
  __syncthreads();
  for (int c0 = 0; c0 < total; c0 += PASS) {
    const float kv = top_v[k - 1];
    const int ki = top_i[k - 1];
    if (tid == 0) s_ncand = 0;
    __syncthreads();
    for (int j = tid; j < PASS && c0 + j < total; j += THREADS) {
      const float v = in_v[base + c0 + j];
      const int r = in_i[base + c0 + j];
      // (+inf, -1) lanes never pass: nothing is below the initial (+inf, -1)
      if (key_less(v, r, kv, ki)) {
        const int s = atomicAdd(&s_ncand, 1);
        cand_v[s] = v;
        cand_i[s] = r;
      }
    }
    __syncthreads();
    const int c = s_ncand;
    if (c > 0) merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
  }
  const size_t o = (static_cast<size_t>(q) * n_out + g) * k;
  for (int i = tid; i < k; i += THREADS) {
    out_v[o + i] = top_v[i];
    out_i[o + i] = top_i[i];
  }
}

template <typename CodeT, bool OFFSETS, int WT>
int launch_scan(const float* tables, const void* codes, const float* bound,
                float* part_v, int* part_i, int n_q, int n_splits,
                int tiles_per_split, int n_rows, int w, int table_width, int k,
                int block_n, cudaStream_t stream) {
  const int tw = OFFSETS && WT > 0 ? WT * NCODES : table_width;
  const size_t smem = scan_smem_bytes(tw, k);
  cudaError_t e = allow_smem(adc_topk_scan_kernel<CodeT, OFFSETS, WT>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  adc_topk_scan_kernel<CodeT, OFFSETS, WT><<<n_q * n_splits, THREADS, smem, stream>>>(
      tables, static_cast<const CodeT*>(codes), bound, part_v, part_i, n_q,
      n_splits, tiles_per_split, n_rows, w, table_width, k, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables (Q, table_width) f32; codes (n_rows, w) in `code_fmt` (0 uint8
// raw + column offsets, 1 uint16, 2 int32 direct addresses); bound (Q,) f32
// or null (+inf).  part_* hold (Q, n_splits, k) and tmp_* (Q,
// ceil(n_splits / 32), k) scratch entries (unused when n_splits == 1);
// out_* (Q, k).  Returns cudaGetLastError() after the launches.
extern "C" int adc_topk_launch(
    const void* tables, const void* codes, const void* bound, void* part_v,
    void* part_i, void* tmp_v, void* tmp_i, void* out_v, void* out_i, int n_q,
    int n_splits, int tiles_per_split, int n_rows, int w, int table_width,
    int code_fmt, int k, int block_n, void* stream) {
  if (n_q <= 0 || n_splits <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = static_cast<float*>(n_splits == 1 ? out_v : part_v);
  int* pi = static_cast<int*>(n_splits == 1 ? out_i : part_i);
  int err = 0;
  auto scan = [&]() -> int {
#define REPRO_TOPK_LAUNCH(CodeT, OFF, WT)                                         \
  launch_scan<CodeT, OFF, WT>(static_cast<const float*>(tables), codes,           \
                              static_cast<const float*>(bound), pv, pi, n_q,      \
                              n_splits, tiles_per_split, n_rows, w, table_width,  \
                              k, block_n, st)
    REPRO_ADC_DISPATCH(code_fmt, w, REPRO_TOPK_LAUNCH)
#undef REPRO_TOPK_LAUNCH
  };
  err = scan();
  if (err != 0) return err;

  const size_t smem = scan_smem_bytes(0, k);
  cudaError_t e = allow_smem(adc_topk_reduce_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // ping-pong: part -> tmp -> part ..., the last level into out
  float* src_v = pv;
  int* src_i = pi;
  int n_lists = n_splits;
  while (n_lists > 1) {
    const int n_out = (n_lists + FAN - 1) / FAN;
    float* dst_v = static_cast<float*>(
        n_out == 1 ? out_v : (src_v == static_cast<float*>(part_v) ? tmp_v : part_v));
    int* dst_i = static_cast<int*>(
        n_out == 1 ? out_i : (src_i == static_cast<int*>(part_i) ? tmp_i : part_i));
    adc_topk_reduce_kernel<<<n_q * n_out, THREADS, smem, st>>>(
        src_v, src_i, dst_v, dst_i, n_lists, n_out, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    src_v = dst_v;
    src_i = dst_i;
    n_lists = n_out;
  }
  return 0;
}
