// Device code shared by the ADC scans: the two pruned scans B2
// (adc_topk_tiles.cu, a flat queue of tiles) and B5 (adc_topk_windows.cu,
// per-pair windows), the unpruned top-k scans B6 (adc_topk.cu) and B7
// (adc_topk_pairs.cu), and the plain scan B8 (adc_scan.cu): the row
// distance for each code format, the skip rule, the shared-memory top-k
// merge and the query bound `sq`.  B2 and B5's shared-memory blocks run one
// block per pair through `scan_pair` and differ only in where a pair's
// tiles come from; they score and merge a tile's rows through `merge_rows`.
// B6 and B7 run the multi-table block of adc_topk_multi.cuh, which merges
// through the same `merge_candidates`; so do B2 and B5 with a table read in
// place (adc_topk_wide.cu: each pair's tiles cut over the grid, the same
// skip rule against each run's own k-th, `pair_run`).
//
// Code formats (template parameters of `scan_pair`):
//   * uint8_t, OFFSETS = true:  raw PQ codes, the column offset m * 256 is
//     added here (the reference's `add_offsets`);
//   * uint16_t / int32_t, OFFSETS = false: direct addresses into the
//     pair's flat table [LUT (M*256) | combo sums | 0] (paper §4.3); the
//     sentinel address is the last entry, which holds 0.0.
// A row of W entries is loaded with the widest aligned vector loads its
// byte width allows (16 bytes per load for W = 16 uint8 or W = 8 uint16),
// and its W table entries are added from 0.0 with no contraction
// (__fadd_rn), bit-equal to the plain versions in kernels/adc_topk.py:
//   * path "gather" (SORT = false): in column order;
//   * path "onehot" (SORT = true, direct addresses only): in ascending
//     address order.  The reference's onehot branch (src/repro/kernels/
//     adc_scan.py `_onehot_dists`) contracts a (rows, A) multi-hot matrix
//     with the flat table, so each row's sum runs over the table's
//     addresses, not its columns; here the row's W addresses are sorted in
//     registers (a sorting network for a compile-time width, a selection
//     scan for a runtime one) and the same W lookups follow in that order.
//     On raw codes the address m * 256 + code grows with m, so table order
//     is column order and the onehot path IS the gather path: raw codes
//     are never instantiated with SORT.
//
// Pruning (the reference's rule, kernels/adc_topk.py module docstring): a
// tile is skipped iff `lb >= pair k-th` or `lb > min(b0, sq[q])`, and a row
// is kept only if `d < k-th` (a row equal to the k-th has a larger row index
// and would lose the tie) and `d <= min(b0, sq[q])`.  Whatever is dropped
// lies strictly beyond the query's final k-th, so every pair's list agrees
// with the unpruned scan on all entries up to that k-th, and the merged
// per-query output is the same in any execution order.  `sq[q]`, the least
// k-th seen among query q's pairs, is shared by all the query's blocks
// through atomicMin on the float's bit pattern (distances are >= 0, so int
// order is float order).
//
// Past shared memory (the reference's Pallas kernels keep a (k,) scratch of
// any k and a table of any width in VMEM).  The shared-memory block holds
// the table, the list and its merge buffer (4k) and a pass of candidates,
// 227 KB at most: it runs for k <= 4096 with a table that fits beside them
// (kernels/adc_topk.py `scan_plan`).  A table too wide to stage at k <=
// 4096 (a uint16 address space of 65,536 entries) runs the in-place block
// of adc_topk_wide.cu: the pairs become units of the multi-table block,
// each pair's tiles cut over the whole grid into runs, each run scanning
// with the rule above against its own list's k-th (never below the pair's,
// and its rows come before the tile's), so the merged per-query output is
// the same.  That block is bound by the table's random loads through L1 /
// L2, not by the code bytes (PERF.md §6).  Past k = 4096 B2 / B5 run the
// select kernels of adc_topk_select.cu (one pair's tiles cut over many
// blocks, its k-th key selected, its k winners sorted), under the same
// contract.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace repro_adc {

constexpr int NCODES = 256;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int PASS = THREADS * ROWS_PER_THREAD;  // rows scored per merge

__device__ __forceinline__ bool key_less(float av, int ar, float bv, int br) {
  return av < bv || (av == bv && ar < br);
}

// Element m of a row held as 32-bit words.
template <typename CodeT>
__device__ __forceinline__ uint32_t word_elem(const uint32_t* w, int m) {
  if constexpr (sizeof(CodeT) == 1) return (w[m >> 2] >> ((m & 3) * 8)) & 0xffu;
  else if constexpr (sizeof(CodeT) == 2) return (w[m >> 1] >> ((m & 1) * 16)) & 0xffffu;
  else return w[m];
}

// Table address of entry m of a row.
template <bool OFFSETS>
__device__ __forceinline__ uint32_t addr_of(uint32_t e, int m) {
  if constexpr (OFFSETS) return static_cast<uint32_t>(m) * NCODES + e;
  else return e;
}

// Batcher's odd-even merge sort of N = 2^j addresses in registers,
// ascending: 19 compare-exchanges for N = 8, 63 for N = 16
// (kernels/adc_topk.py `sort_network_size` counts them for the bounds).
// The network's four loops (p, k, j, i) are template recursions, so every
// compare-exchange names its two elements at compile time and the array
// stays in registers: one runtime index would put it in local memory.
template <int N, int I, int J>
__device__ __forceinline__ void compare_exchange(uint32_t (&a)[N]) {
  const uint32_t x = a[I], y = a[J];
  a[I] = min(x, y);
  a[J] = max(x, y);
}

template <int N, int P, int K, int J, int I>
__device__ __forceinline__ void network_i(uint32_t (&a)[N]) {
  if constexpr (I < K) {
    if constexpr (I + J + K < N && (I + J) / (2 * P) == (I + J + K) / (2 * P))
      compare_exchange<N, I + J, I + J + K>(a);
    network_i<N, P, K, J, I + 1>(a);
  }
}

template <int N, int P, int K, int J>
__device__ __forceinline__ void network_j(uint32_t (&a)[N]) {
  if constexpr (J + K < N) {
    network_i<N, P, K, J, 0>(a);
    network_j<N, P, K, J + 2 * K>(a);
  }
}

template <int N, int P, int K>
__device__ __forceinline__ void network_k(uint32_t (&a)[N]) {
  if constexpr (K >= 1) {
    network_j<N, P, K, K % P>(a);
    network_k<N, P, K / 2>(a);
  }
}

template <int N, int P>
__device__ __forceinline__ void network_p(uint32_t (&a)[N]) {
  if constexpr (P < N) {
    network_k<N, P, P>(a);
    network_p<N, 2 * P>(a);
  }
}

template <int N>
__device__ __forceinline__ void sort_network(uint32_t (&a)[N]) {
  static_assert(N > 0 && (N & (N - 1)) == 0, "the network sorts a power of two");
  network_p<N, 1>(a);
}

// The least (address, column) key of a row above (la, lc): the next step
// of the selection scan that orders a row of runtime width w without an
// array (w passes over the row, each re-read from L1).  Equal addresses
// come out one after another, so each occurrence is added once.
template <typename CodeT>
__device__ __forceinline__ uint32_t next_address(const CodeT* __restrict__ row, int w,
                                                 uint32_t& la, int& lc) {
  uint32_t ba = 0xffffffffu;
  int bc = INT_MAX;
  for (int m = 0; m < w; ++m) {
    const uint32_t a = static_cast<uint32_t>(row[m]);
    const bool after = a > la || (a == la && m > lc);
    const bool less = a < ba || (a == ba && m < bc);
    if (after && less) {
      ba = a;
      bc = m;
    }
  }
  la = ba;
  lc = bc;
  return ba;
}

// ADC distance of one row: sum of its W table entries, in column order
// (SORT = false) or in ascending address order (SORT = true, direct
// addresses).  WT > 0 is the width known at compile time; WT == 0 reads
// w_rt entries.
template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__device__ __forceinline__ float adc_row(const float* table,
                                         const CodeT* __restrict__ row,
                                         int w_rt) {
  static_assert(!(SORT && OFFSETS), "raw codes are already in table order");
  constexpr int BYTES = WT * static_cast<int>(sizeof(CodeT));
  if constexpr (WT > 0 && BYTES % 4 == 0) {
    uint32_t w[BYTES / 4];
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int q = 0; q < BYTES / 16; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    } else if constexpr (BYTES % 8 == 0) {
#pragma unroll
      for (int q = 0; q < BYTES / 8; ++q) {
        const uint2 v = reinterpret_cast<const uint2*>(row)[q];
        w[2 * q] = v.x;
        w[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < BYTES / 4; ++q)
        w[q] = reinterpret_cast<const uint32_t*>(row)[q];
    }
    float d = 0.f;
    if constexpr (SORT) {
      uint32_t a[WT];
#pragma unroll
      for (int m = 0; m < WT; ++m) a[m] = word_elem<CodeT>(w, m);
      sort_network<WT>(a);
#pragma unroll
      for (int m = 0; m < WT; ++m) d = __fadd_rn(d, table[a[m]]);
    } else {
#pragma unroll
      for (int m = 0; m < WT; ++m)
        d = __fadd_rn(d, table[addr_of<OFFSETS>(word_elem<CodeT>(w, m), m)]);
    }
    return d;
  } else {
    float d = 0.f;
    if constexpr (SORT) {
      uint32_t la = 0;
      int lc = -1;
      for (int s = 0; s < w_rt; ++s) d = __fadd_rn(d, table[next_address(row, w_rt, la, lc)]);
    } else {
      for (int m = 0; m < w_rt; ++m)
        d = __fadd_rn(d, table[addr_of<OFFSETS>(static_cast<uint32_t>(row[m]), m)]);
    }
    return d;
  }
}

// Merge the c candidates in cand_* into the ascending top-k list top_*.
// Every thread of the block calls it; it ends with a barrier.
__device__ inline void merge_candidates(float* top_v, int* top_i, float* nxt_v,
                                        int* nxt_i, float* cand_v, int* cand_i,
                                        int c, int k) {
  const int tid = threadIdx.x;
  int n2 = 1;
  while (n2 < c) n2 <<= 1;
  for (int i = c + tid; i < n2; i += THREADS) {
    cand_v[i] = CUDART_INF_F;
    cand_i[i] = INT_MAX;
  }
  __syncthreads();
  // bitonic sort of the candidates, ascending by (distance, row)
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const float vi = cand_v[i], vj = cand_v[j];
          const int ri = cand_i[i], rj = cand_i[j];
          const bool up = (i & size) == 0;
          if (up ? key_less(vj, rj, vi, ri) : key_less(vi, ri, vj, rj)) {
            cand_v[i] = vj;
            cand_v[j] = vi;
            cand_i[i] = rj;
            cand_i[j] = ri;
          }
        }
      }
      __syncthreads();
    }
  }
  // merge path: each element's output slot is its own index plus the
  // number of elements of the other list that precede it.  Keys are
  // unique across the two lists (rows differ; candidates are finite).
  const int cb = min(c, k);
  for (int i = tid; i < k; i += THREADS) {
    const float v = top_v[i];
    const int r = top_i[i];
    int lo = 0, hi = cb;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(cand_v[mid], cand_i[mid], v, r)) lo = mid + 1; else hi = mid;
    }
    if (i + lo < k) {
      nxt_v[i + lo] = v;
      nxt_i[i + lo] = r;
    }
  }
  for (int j = tid; j < cb; j += THREADS) {
    const float v = cand_v[j];
    const int r = cand_i[j];
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(top_v[mid], top_i[mid], v, r)) lo = mid + 1; else hi = mid;
    }
    if (j + lo < k) {
      nxt_v[j + lo] = v;
      nxt_i[j + lo] = r;
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += THREADS) {
    top_v[i] = nxt_v[i];
    top_i[i] = nxt_i[i];
  }
  __syncthreads();
}

// Dynamic shared memory of one scan block: the pair's table (A floats),
// the top-k list and its merge buffer (4k), the candidates (2 * PASS).
inline size_t scan_smem_bytes(int table_width, int k) {
  return (static_cast<size_t>(table_width) + 4 * k + 2 * PASS) * 4;
}

// Score the n_rows rows of `tile` (its first row is row `row0` of the
// output's numbering) PASS rows at a time, and merge those with
// d < k-th and d <= qb into the block's ascending top-k list.  The tile's
// rows come after every row already in the list, so a row equal to the
// k-th would lose the tie and is not kept.  Every thread of the block
// calls it; the lists and candidate buffers are the shared-memory layout
// of `scan_smem_bytes`, `s_ncand` a shared counter.
template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__device__ __forceinline__ void merge_rows(const float* table,
                                           const CodeT* __restrict__ tile, int W,
                                           int n_rows, int row0, float qb,
                                           float* top_v, int* top_i, float* nxt_v,
                                           int* nxt_i, float* cand_v, int* cand_i,
                                           int* s_ncand, int k) {
  const int tid = threadIdx.x;
  for (int base = 0; base < n_rows; base += PASS) {
    const float kth = top_v[k - 1];
    float d[ROWS_PER_THREAD];
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int i = base + j * THREADS + tid;
      d[j] = i < n_rows ? adc_row<CodeT, OFFSETS, WT, SORT>(
                              table, tile + static_cast<size_t>(i) * W, W)
                        : CUDART_INF_F;
    }
    if (tid == 0) *s_ncand = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ROWS_PER_THREAD; ++j) {
      const int i = base + j * THREADS + tid;
      if (i < n_rows && d[j] < kth && d[j] <= qb) {
        const int s = atomicAdd(s_ncand, 1);
        cand_v[s] = d[j];
        cand_i[s] = row0 + i;
      }
    }
    __syncthreads();
    const int c = *s_ncand;
    if (c > 0)
      merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
  }
}

// Blocks per SM the scan kernels are compiled for.  Six hold the uint8
// and uint16 scans to 40 registers (without the bound the raw-code scan
// of a compile-time width takes 48, five blocks, and runs slower); int32
// addresses need 48.  The onehot path's sort holds a row's W addresses in
// registers beside the lookups: four blocks, 64 registers.
template <typename CodeT, bool SORT>
constexpr int scan_min_blocks() { return SORT ? 4 : (sizeof(CodeT) < 4 ? 6 : 5); }

struct TileRef {
  int row0;  // first window row of the tile
  int blk;   // block index of the tile in the device's code array
};

// One pair's scan, by the whole block: load its table row into shared
// memory, walk its n_tiles tiles (tile_at(t) -> TileRef, ascending rows),
// skip, score, merge, tighten sq, and write the pair's (k) outputs and its
// [tiles skipped, rows avoided] counters.  `cdev` is the pair's device's
// (cap, W) codes.  Raw codes of a compile-time width address only the
// first WT * 256 entries, so that many are loaded, a compile-time count
// that also fixes the shared-memory offsets of the lists behind the table.
template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename TileAt>
__device__ void scan_pair(const float* __restrict__ table_row, int table_width_rt,
                          const CodeT* __restrict__ cdev, int w_rt,
                          int n_tiles, TileAt tile_at, int nv, int qi,
                          float lb, float b0, float* sq, int k, int block_n,
                          float* __restrict__ out_v, int* __restrict__ out_i,
                          int* __restrict__ stats) {
  const int table_width = OFFSETS && WT > 0 ? WT * NCODES : table_width_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  float* table = reinterpret_cast<float*>(smem);
  float* top_v = table + table_width;
  int* top_i = reinterpret_cast<int*>(top_v + k);
  float* nxt_v = reinterpret_cast<float*>(top_i + k);
  int* nxt_i = reinterpret_cast<int*>(nxt_v + k);
  float* cand_v = reinterpret_cast<float*>(nxt_i + k);
  int* cand_i = reinterpret_cast<int*>(cand_v + PASS);
  __shared__ int s_ncand;
  __shared__ int s_skip;
  __shared__ float s_qb;

  const int W = WT > 0 ? WT : w_rt;
  const int tid = threadIdx.x;
  for (int i = tid; i < table_width; i += THREADS) table[i] = table_row[i];
  for (int i = tid; i < k; i += THREADS) {
    top_v[i] = CUDART_INF_F;
    top_i[i] = -1;
  }
  int n_skip = 0, n_avoid = 0;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const TileRef tr = tile_at(t);
    if (tid == 0) {
      const float qb = fminf(b0, __ldcg(sq + qi));
      const float kth = top_v[k - 1];
      const int skip = (lb >= kth) || (lb > qb);
      if (skip) {
        const int rows = min(max(nv - tr.row0, 0), block_n);
        n_skip += rows > 0;
        n_avoid += rows;
      }
      s_skip = skip;
      s_qb = qb;
    }
    __syncthreads();
    if (!s_skip) {
      const int n_rows = min(block_n, nv - tr.row0);
      const CodeT* tile = cdev + static_cast<size_t>(tr.blk) * block_n * W;
      merge_rows<CodeT, OFFSETS, WT, SORT>(table, tile, W, n_rows, tr.row0, s_qb, top_v,
                                     top_i, nxt_v, nxt_i, cand_v, cand_i, &s_ncand, k);
    }
    if (tid == 0) {
      const float kth = top_v[k - 1];
      if (kth < CUDART_INF_F)
        atomicMin(reinterpret_cast<int*>(sq + qi), __float_as_int(kth));
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += THREADS) {
    out_v[i] = top_v[i];
    out_i[i] = top_i[i];
  }
  if (tid == 0) {
    stats[0] = n_skip;
    stats[1] = n_avoid;
  }
}

// Raise the dynamic shared-memory limit of `kernel` when a block needs
// more than the default 48 KB.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace repro_adc

// The instantiations of an in-place or select launcher: compile-time width
// 16 for raw uint8 codes and uint16 addresses (the main path's widths), a
// runtime width for the rest; the same sums in the same order at every
// width.
#define REPRO_ADC_DISPATCH_WIDE(fmt, w, onehot, LAUNCH)                          \
  switch (fmt) {                                                                 \
    case 0:                                                                      \
      return (w) == 16 ? LAUNCH(uint8_t, true, 16, false)                        \
                       : LAUNCH(uint8_t, true, 0, false);                        \
    case 1:                                                                      \
      if ((w) == 16)                                                             \
        return (onehot) ? LAUNCH(uint16_t, false, 16, true)                      \
                        : LAUNCH(uint16_t, false, 16, false);                    \
      return (onehot) ? LAUNCH(uint16_t, false, 0, true)                         \
                      : LAUNCH(uint16_t, false, 0, false);                       \
    case 2:                                                                      \
      return (onehot) ? LAUNCH(int32_t, false, 0, true)                          \
                      : LAUNCH(int32_t, false, 0, false);                        \
    default:                                                                     \
      return static_cast<int>(cudaErrorInvalidValue);                            \
  }

// Instantiate LAUNCH(CodeT, OFFSETS, WT, SORT) for the code format `fmt`
// (0: uint8 + offsets, 1: uint16 direct, 2: int32 direct), width w and
// path (`onehot` nonzero: the onehot path, SORT on direct addresses; raw
// codes have one instantiation for both paths), with compile-time widths
// for the common cases.
#define REPRO_ADC_DIRECT(CodeT, w, onehot, LAUNCH)                          \
  switch (w) {                                                             \
    case 8:                                                                \
      return (onehot) ? LAUNCH(CodeT, false, 8, true)                      \
                      : LAUNCH(CodeT, false, 8, false);                    \
    case 16:                                                               \
      return (onehot) ? LAUNCH(CodeT, false, 16, true)                     \
                      : LAUNCH(CodeT, false, 16, false);                   \
    default:                                                               \
      return (onehot) ? LAUNCH(CodeT, false, 0, true)                      \
                      : LAUNCH(CodeT, false, 0, false);                    \
  }

#define REPRO_ADC_DISPATCH(fmt, w, onehot, LAUNCH)                 \
  switch (fmt) {                                                  \
    case 0:                                                       \
      switch (w) {                                                \
        case 8: return LAUNCH(uint8_t, true, 8, false);           \
        case 16: return LAUNCH(uint8_t, true, 16, false);         \
        case 32: return LAUNCH(uint8_t, true, 32, false);         \
        default: return LAUNCH(uint8_t, true, 0, false);          \
      }                                                           \
    case 1:                                                       \
      REPRO_ADC_DIRECT(uint16_t, w, onehot, LAUNCH)               \
    case 2:                                                       \
      REPRO_ADC_DIRECT(int32_t, w, onehot, LAUNCH)                \
    default:                                                      \
      return static_cast<int>(cudaErrorInvalidValue);             \
  }
