// The in-place block: kernels B6, B7, B2 and B5 at k <= 4096 with a table
// too wide to stage in shared memory (a uint16 address space of 65,536
// entries, 256 KB), read where it lies (a larger k runs the select kernels
// of adc_topk_select.cu).
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_kernel` (B6),
//           `adc_topk_pairs_kernel` (B7), `adc_topk_tiles_kernel` (B2) and
//           `adc_topk_windows_kernel` (B5), over the part of their domain
//           the shared-memory blocks do not hold: the Pallas kernels keep a
//           table of any width in VMEM.
//
// It is the multi-table block of adc_topk_multi.cuh run on `WideArgs`: the
// same units, runs cut over the grid, passes, candidate test, merges and
// merge tree, each sum the same `__fadd_rn` chain in column (gather) or
// address (onehot) order, so the same rows by (distance, row), bit-equal
// to the plain versions.
//   * B6 / B7 (`adc_topk_wide_launch`): units of G = 1, 2 or 4 tables
//     (kernels/adc_topk.py `topk_plan` picks G by its cost model with the
//     in-place lookup costs `_INPLACE_CLOCKS`; B7 stays at G = 1).  At G =
//     1 a unit reads its table row itself; at G > 1 a first kernel
//     (`adc_topk_interleave_kernel`) lays each unit's G tables out as [A][G]
//     in the wrapper's workspace, so each address of a row is one 16-byte
//     (G = 4) or 8-byte (G = 2) load through the read-only path feeding G
//     sums, and the codes are read once for the G tables.
//   * Every unit's tiles are cut over the grid; a block finds its first
//     unit by a binary search of the units' first tiles (`ustart`, written
//     by a one-block plan kernel for B7's windows, grouped B6 and B2 /
//     B5's pairs; B6's units over one code array start at multiples of
//     their tiles).
//   * B2 / B5 (`adc_topk_scan_wide_launch`): the pairs as G = 1 units, each
//     pair's tiles cut over the whole grid like any unit's; a run skips and
//     keeps rows by the exact rule of adc_topk_common.cuh against its own
//     list's k-th (`pair_run`), its list merges through the ticket tree
//     and its counters by atomics, so a few long pairs keep every SM busy
//     (one block a pair would leave the smoke's 30 pairs on 30 of 528
//     blocks, the longest pair's chain the call).
//
// What bounds it on an H100: not the code bytes the bound counts, but the
// table's random loads: each row's W addresses are W warp-wide loads of 32
// random sectors each, through L1 (an SM's L1 holds part of a 256 KB table,
// none of the 1 MB of four interleaved ones) and L2.  G = 4 issues a
// quarter of G = 1's load instructions for four tables; measured on NVIDIA
// H100 80GB HBM3, 700.00 W in PERF.md §6 (tools/probe_inplace.py).

#include "adc_topk_wide.cuh"

namespace {

// Unit u's nq <= G tables, entries [0, a_used) of rows q0 .. q0 + nq - 1
// of `tables`, as ilv[u][e][0 .. G) (0.0 past nq): one G-wide vector store
// an entry.  B6 over one code array (units null): unit u is tables u * G ..
template <int G>
__global__ void __launch_bounds__(THREADS)
adc_topk_interleave_kernel(const float* __restrict__ tables, const int* __restrict__ units,
                           float* __restrict__ ilv, int n_units, int n_q, int table_width,
                           int a_used) {
  static_assert(G == 2 || G == 4, "units of 2 or 4 tables are interleaved");
  using Vec = typename std::conditional<G == 4, float4, float2>::type;
  for (int u = blockIdx.y; u < n_units; u += gridDim.y) {
    const int q0 = units != nullptr ? __ldg(units + 4 * u + 2) : u * G;
    const int nq = units != nullptr ? __ldg(units + 4 * u + 3) : min(G, n_q - q0);
    Vec* out = reinterpret_cast<Vec*>(ilv) + static_cast<size_t>(u) * a_used;
    for (int e = blockIdx.x * THREADS + threadIdx.x; e < a_used; e += gridDim.x * THREADS) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (g < nq) v[g] = __ldg(tables + static_cast<size_t>(q0 + g) * table_width + e);
      if constexpr (G == 4) out[e] = make_float4(v[0], v[1], v[2], v[3]);
      else out[e] = make_float2(v[0], v[1]);
    }
  }
}

template <int G>
int interleave(const WideArgs& a, int a_used, cudaStream_t stream) {
  const int gx = min((a_used + THREADS - 1) / THREADS, 1024);
  const dim3 grid(gx, min(a.n_units, 65535));
  adc_topk_interleave_kernel<G><<<grid, THREADS, 0, stream>>>(
      a.tables, a.units, const_cast<float*>(a.ilv), a.n_units, a.n_q, a.table_width, a_used);
  return static_cast<int>(cudaGetLastError());
}

// The plan, one block: ustart[u] = the tiles of units 0 .. u-1,
// ustart[n_units] = T (`inplace_tiles`: B6's grouped units and B7's
// windows, B2 / B5's pairs; the select's plan step on the in-place block's
// arguments).
// Each thread loads PLAN_UNITS units' counts before the block scans them,
// so their loads (a chain of two or three for a pair) are in flight
// together.
constexpr int PLAN_UNITS = 8;

template <typename Args>
__global__ void __launch_bounds__(THREADS) adc_topk_inplace_plan_kernel(const Args a,
                                                                        long long* ustart) {
  __shared__ long long s_red64[THREADS / 32];
  long long base = 0;
  for (int c0 = 0; c0 < a.n_units; c0 += THREADS * PLAN_UNITS) {
    long long cnt[PLAN_UNITS];
#pragma unroll
    for (int j = 0; j < PLAN_UNITS; ++j) {
      const int u = c0 + j * THREADS + static_cast<int>(threadIdx.x);
      cnt[j] = u < a.n_units ? inplace_tiles(a, u) : 0;
    }
#pragma unroll
    for (int j = 0; j < PLAN_UNITS; ++j) {
      const int u = c0 + j * THREADS + static_cast<int>(threadIdx.x);
      long long chunk;
      const long long before = block_scan(cnt[j], s_red64, &chunk);
      if (u < a.n_units) ustart[u] = base + before;
      base += chunk;
    }
  }
  if (threadIdx.x == 0) ustart[a.n_units] = base;
}

template <typename Args>
int plan(const Args& a, cudaStream_t stream) {
  adc_topk_inplace_plan_kernel<Args><<<1, THREADS, 0, stream>>>(a, const_cast<long long*>(a.ustart));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call of B6 / B7 in place: the plan kernel when the units are
// grouped or B7's windows (their first tiles into ustart), the interleave
// kernel at g > 1, then the scan (1 to 3 CUDA launches).  B6: units
// (n_units, 4) int32 {row0, n_rows, q0, nq <= g} or null (ceil(n_q / g)
// units over all n_rows rows, no plan), n_valid null.  B7 (g = 1): n_valid
// (n_units,) int32 and win_len rows a window, units null.  tables (n_q,
// table_width) f32; codes in `code_fmt` (0 uint8 raw + column offsets, 1
// uint16, 2 int32 direct addresses); bound (n_q,) f32 or null; out_* (n_q,
// k); part_* (n_blocks + n_units) * g * k scratch entries, tickets
// n_blocks + 2 * n_units int32 zeros (left zero); ilv (g > 1) n_units *
// a_used * g floats (a_used: w * 256 for raw codes, else table_width);
// ustart (n_units + 1,) int64 scratch.  Returns the first non-zero
// cudaError_t, or 0.
extern "C" int adc_topk_wide_launch(const void* tables, const void* codes, const void* bound,
                                    const void* units, const void* n_valid, void* out_v,
                                    void* out_i, void* part_v, void* part_i, void* tickets,
                                    void* ilv, void* ustart, long long win_len, int n_units,
                                    int n_q, int n_rows, int w, int table_width, int code_fmt,
                                    int onehot, int k, int block_n, int g, int n_blocks,
                                    void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  const bool planned = units != nullptr || n_valid != nullptr;
  const WideArgs a{{static_cast<const float*>(tables), codes, static_cast<const float*>(bound),
                    static_cast<const int*>(units), static_cast<const int*>(n_valid),
                    static_cast<float*>(out_v), static_cast<int*>(out_i),
                    static_cast<float*>(part_v), static_cast<int*>(part_i),
                    static_cast<int*>(tickets), win_len, n_units, n_q, n_rows, w, table_width, k,
                    block_n},
                   static_cast<const float*>(ilv),
                   planned ? static_cast<const long long*>(ustart) : nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = planned ? plan(a, st) : 0;
  if (e != 0) return e;
  if (g == 1) return wide_launch<1>(a, code_fmt, w, onehot, n_blocks, st);
  const int a_used = code_fmt == 0 ? w * NCODES : table_width;
  e = g == 4 ? interleave<4>(a, a_used, st)
             : (g == 2 ? interleave<2>(a, a_used, st) : static_cast<int>(cudaErrorInvalidValue));
  if (e != 0) return e;
  return repro_adc::adc_topk_wide_launch_g24(a, g, code_fmt, w, onehot, n_blocks, st);
}

// One call of B2 (pair_t0 / pair_t1 / tile_block / tile_row0 given, starts
// null) or B5 (starts given, the tile arrays null) in place, over the
// n_units pairs of `order`, as adc_topk_tiles_launch /
// adc_topk_windows_launch take them: tables (R, table_width) f32, lut_row /
// n_valid / pair_q / pair_lb (P_all,), codes (ndev, cap, w), bound and sq
// (Q,) f32 (sq tightened in place), out_* (P_all, k) and stats (P_all, 2):
// each unit's pair with tiles rewritten.  Two CUDA launches: the plan
// kernel writes the units' first tiles and their total into ustart
// ((n_units + 1,) int64 scratch), then the scan.  part_* (n_blocks +
// n_units) * k scratch entries; tickets n_blocks + 5 * n_units int32 zeros
// (left zero).  Returns the first non-zero cudaError_t, or 0.
extern "C" int adc_topk_scan_wide_launch(
    const void* tables, const void* lut_row, const void* codes, const void* order,
    void* ustart, const void* pair_t0, const void* pair_t1, const void* tile_block,
    const void* tile_row0, const void* starts, const void* n_valid, const void* pair_q,
    const void* pair_lb, const void* bound, void* sq, void* out_v, void* out_i, void* stats,
    void* part_v, void* part_i, void* tickets, int n_units, int pairs_per_dev, long long cap,
    int w, int table_width, int code_fmt, int onehot, int k, int block_n, int n_blocks,
    void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  auto ci = [](const void* p) { return static_cast<const int*>(p); };
  int* tk = static_cast<int*>(tickets);
  const ScanWideArgs a{
      {{static_cast<const float*>(tables), codes, static_cast<const float*>(bound), nullptr,
        nullptr, static_cast<float*>(out_v), static_cast<int*>(out_i),
        static_cast<float*>(part_v), static_cast<int*>(part_i), tk, 0, n_units, 0, 0, w,
        table_width, k, block_n},
       nullptr, static_cast<const long long*>(ustart)},
      ci(lut_row), ci(order), ci(pair_t0), ci(pair_t1), ci(tile_block), ci(tile_row0),
      ci(starts), ci(n_valid), ci(pair_q), static_cast<const float*>(pair_lb),
      static_cast<float*>(sq), static_cast<int*>(stats),
      tk + n_blocks + 2 * static_cast<size_t>(n_units), cap, pairs_per_dev};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = plan(a, st);
  if (e != 0) return e;
  return wide_launch<1>(a, code_fmt, w, onehot, n_blocks, st);
}

// Resident blocks per SM of the scan kernel `adc_topk_wide_launch` (pairs
// 0, at g) or `adc_topk_scan_wide_launch` (pairs nonzero, g 1) would run, or
// minus a cudaError_t.
extern "C" int adc_topk_wide_blocks_per_sm(int code_fmt, int onehot, int w, int table_width,
                                           int k, int g, int pairs) {
  if (pairs) return wide_blocks_per_sm<1, ScanWideArgs>(code_fmt, onehot, w, table_width, k);
  if (g == 1) return wide_blocks_per_sm<1, WideArgs>(code_fmt, onehot, w, table_width, k);
  return repro_adc::adc_topk_wide_blocks_per_sm_g24(g, code_fmt, onehot, w, table_width, k);
}
