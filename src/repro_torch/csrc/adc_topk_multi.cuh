// Device code of the unpruned top-k scans B6 (adc_topk.cu: G tables over
// one code array, or over groups of rows) and B7 (adc_topk_pairs.cu: one
// table per materialised window), both one launch per call.
//
// Work.  The caller's work is a list of UNITS.  A unit is a range of rows
// of the code array (row0, n_rows) and up to G consecutive table rows
// (q0, nq) that all scan it; its tiles are its rows cut at every block_n
// (row r of the unit, numbered from row0, lies in tile r / block_n).  B6
// over one code array is ceil(Q / G) units of the same rows; grouped B6
// (the flat search) is each group's tables cut into G-sized units; B7 is
// one unit per pair (G = 1) with n_rows = n_valid[p], read on the card.
//
// Plan (`topk_multi`; the Python twin is kernels/adc_topk.py `run_plan`).
// The units' tiles, concatenated in unit order, are T tiles.  The grid is
// sized from the SM count; with nb = min(gridDim.x, T) blocks, block b takes
// the tiles [b * T / nb, (b + 1) * T / nb), at least one each, and walks the
// units they cover: a RUN is the part of one unit inside one block's range,
// ascending rows.  Every block computes the units' tile prefix itself
// (a block-wide scan, THREADS units at a time), so nothing is planned on
// the host and B7's n_valid never leaves the card.  The runs of unit u are
// those of blocks first(u) .. last(u); along the tiles, every step moves to
// the next unit, the next block or both, so slot b + u numbers the
// (block, unit) pairs without a gap or a repeat (fewer than nb + units).
//
// Scan (`scan_run`).  The block loads its unit's G tables into shared
// memory interleaved by G ([A][G]: the G entries of one address are one
// 16-byte LDS.128 for G = 4), then walks its run PASS rows at a time: each
// thread loads its rows' codes once (the widest aligned vector loads),
// computes each address once and adds its G entries to G sums, each in
// column order with __fadd_rn (bit-equal to the plain version); on the
// onehot path (SORT, direct addresses) each row's addresses are sorted
// once, in registers, and the G tables take their lookups in ascending
// address order (adc_topk_common.cuh says why).  A row is a
// candidate of table g if its distance is below that table's current k-th
// (a row equal to it has a larger row index and loses the tie); candidates
// are collected per warp (ballot, popcount) and merged into table g's
// ascending top-k list (`merge_candidates`, shared with B2 / B5).  The
// steady state costs one block vote per pass.  With a finite bound for any
// of the unit's tables, passes follow the caller's tiles: a tile is merged
// into table g only if its smallest distance is <= bound[g], that minimum
// taken from the same sums when the tile fits in one pass (block_n <=
// PASS), else from a first sweep.
//
// Merge (`finish_run`).  A unit with one run writes its lists to the
// output.  Otherwise each run writes its G lists to scratch slot b + u;
// the last block of each group of ceil(sqrt(runs)) consecutive runs (an
// atomic ticket after __threadfence) merges the group's lists, and the
// last group to finish merges the groups' lists into the output: the lists
// stream through the same candidate merge, every entry tested against the
// running k-th key first, and each ticket is reset to 0 for the next call.
// Few candidates (<= 32) merge in one warp (`merge_small`).
// A row lies in exactly one run, so keys (distance, row) are unique and the
// result is the k smallest rows by (distance, row) whatever G, the grid or
// the run boundaries.
//
// Measured costs behind the design (tools/bench_smem_lookup.cu, NVIDIA H100
// 80GB HBM3): a warp-wide lookup at random addresses takes 3.16 SM clocks
// as LDS.32, 2.91 per entry as LDS.64 and 2.54 per entry as LDS.128, so
// four tables interleaved cost 0.80x of four scalar lookups.
//
// The in-place block (adc_topk_wide.cu) is this block run on `WideArgs`,
// for every table too wide to stage at k <= 4096: the unit's tables are
// read where they lie, through the read-only path (`multi_add` with LDG).
// B6 / B7 run their units on it at G = 1, 2 or 4 tables a unit: at G = 1
// from the table row itself, at G > 1 from `WideArgs::ilv`, the units'
// tables interleaved [A][G] by the launcher's interleave kernel, so one
// address is one 16-byte load (G = 4) feeding four sums.  B2 / B5 run
// their pairs on it as G = 1 units (`ScanWideArgs`): a pair's tiles are
// cut over the grid like any unit's, each run scans its part with the
// pruning of adc_topk_common.cuh (`pair_run`), the runs' lists merge
// through `finish_run` and their counters by atomics.  Every function the
// shared-memory block runs keeps its code: the in-place parts are
// overloads and branches on the arguments' type.  Past the lists' k (k > 4096) B6 / B7 (and B2 /
// B5) run the select kernels of adc_topk_select.cu, which score through
// `multi_load` / `multi_score`.

#pragma once

#include <type_traits>

#include "adc_topk_common.cuh"

namespace repro_adc {

// rows of one pass per thread: as many as fit 64 bytes of codes, 1 to 4
template <typename CodeT, int WT>
__host__ __device__ constexpr int multi_rows() {
  constexpr int b = WT * static_cast<int>(sizeof(CodeT));
  return WT == 0 ? 4 : (b >= 64 ? 1 : (b >= 32 ? 2 : 4));
}

// Blocks per SM the multi-table scan is compiled for (its register cap:
// 64 registers at G = 1, 128 at G = 4).  With the prefetched codes, five
// blocks at G = 1 (48 registers, 192 bytes of spills) ran 22 % slower and
// three at G = 4 (80 registers) 5 % slower on an H100 (PERF.md §6).
template <int G>
__host__ __device__ constexpr int multi_min_blocks() {
  return G == 1 ? 4 : 2;
}

struct MultiArgs {
  const float* tables;   // (Q, table_width)
  const void* codes;     // (rows, w)
  const float* bound;    // (Q,) or null: +inf
  const int* units;      // (n_units, 4) {row0, n_rows, q0, nq} or null
  const int* n_valid;    // B7: (n_units,) valid rows per window, or null
  float* out_v;          // (Q, k)
  int* out_i;            // (Q, k)
  float* part_v;         // scratch lists: (slots, G, k)
  int* part_i;
  int* tickets;          // (slots + n_units,), zero between calls
  long long win_len;     // B7: rows per window
  int n_units, n_q, n_rows, w, table_width, k, block_n;
};

// The in-place block's arguments: the units of MultiArgs, each unit's G
// tables read where they lie (G = 1: row q0 of `tables`; G > 1: unit u's
// [A][G] block of `ilv`), and the units' first tiles `ustart` (the
// launcher's plan kernel), or null for B6 over one code array, whose unit
// u starts at tile u * ceil(n_rows / block_n).
struct WideArgs : MultiArgs {
  const float* ilv;          // (n_units, A, G) interleaved tables, or null at G = 1
  const long long* ustart;   // (n_units + 1,): the units' first tiles, then T; or null
};

// B2 / B5's pairs as the in-place block's units (G = 1): unit u is pair
// order[u], its table row lut_row[pair], its tiles B2's run of the tile
// queue (pair_t0 / pair_t1 / tile_block / tile_row0, ascending rows) or
// B5's blocks 0 .. ceil(n_valid / block_n) - 1 of its window from `starts`
// (the fields of adc_topk_select.cu's ScanSelectArgs), none without a
// table (`ustart` as WideArgs', always given).  `bound` holds the
// queries' b0; `counters` (3 n_units int32, zero between calls, left zero)
// sums a pair's [tiles skipped, rows avoided] over its runs and counts the
// runs done.
struct ScanWideArgs : WideArgs {
  const int* lut_row;     // (P_all,)
  const int* order;       // (n_units,)
  const int* pair_t0;     // B2: (P_all,) the pair's tiles [t0, t1) of the queue; null for B5
  const int* pair_t1;
  const int* tile_block;  // B2: (ndev * T_queue,)
  const int* tile_row0;
  const int* starts;      // B5: (P_all,) the window's first row (block-aligned)
  const int* pair_nv;     // (P_all,) valid rows
  const int* pair_q;      // (P_all,)
  const float* pair_lb;   // (P_all,)
  float* sq;              // (Q,) the queries' shared bound
  int* stats;             // (P_all, 2) [tiles skipped, rows avoided]
  int* counters;          // (n_units, 3)
  long long cap;          // code rows a device
  int pairs_per_dev;
};

template <typename Args>
constexpr bool kInPlace = std::is_base_of<WideArgs, Args>::value;
template <typename Args>
constexpr bool kPairUnits = std::is_same<Args, ScanWideArgs>::value;

// Tiles of B2 / B5's unit u: its pair's run of the tile queue or its
// window's blocks, none without a table (the select's `unit_tiles`).
__device__ __forceinline__ long long pair_tiles(const ScanWideArgs& a, int u) {
  const int p = __ldg(a.order + u);
  if (__ldg(a.lut_row + p) < 0) return 0;
  if (a.pair_t0 != nullptr) return max(__ldg(a.pair_t1 + p) - __ldg(a.pair_t0 + p), 0);
  return (max(__ldg(a.pair_nv + p), 0) + a.block_n - 1) / a.block_n;
}

struct Unit {
  long long row0;
  int n_rows, q0, nq;
};

// Unit u: from the descriptor, from B7's windows, or one code array's
// chunks of G tables.
template <int G>
__device__ __forceinline__ Unit unit_at(const MultiArgs& a, int u) {
  if (a.n_valid != nullptr) {
    const long long nv = min(static_cast<long long>(max(__ldg(a.n_valid + u), 0)), a.win_len);
    return Unit{u * a.win_len, static_cast<int>(nv), u, 1};
  }
  if (a.units != nullptr) {
    const int* d = a.units + 4 * u;
    return Unit{__ldg(d), __ldg(d + 1), __ldg(d + 2), __ldg(d + 3)};
  }
  return Unit{0, a.n_rows, u * G, min(G, a.n_q - u * G)};
}

// Table entries a block keeps: raw codes of a compile-time width address
// only their first WT * 256 entries.
template <bool OFFSETS, int WT>
__host__ __device__ __forceinline__ int multi_table_width(int table_width, int w) {
  return OFFSETS ? (WT > 0 ? WT : w) * NCODES : table_width;
}

// Dynamic shared memory of a block: G tables, G top-k lists and one merge
// buffer (k), one pass of candidates (PASS = 1024 at most).  The in-place
// block leaves out the tables (`in_place`).
inline size_t multi_smem_bytes(int g, int a_used, int k, bool in_place = false) {
  return (static_cast<size_t>(in_place ? 0 : g) * a_used + 2 * static_cast<size_t>(g) * k +
          2 * k + 2 * PASS) * 4;
}

inline size_t args_smem_bytes(const MultiArgs& a, int g, int a_used) {
  return multi_smem_bytes(g, a_used, a.k);
}
inline size_t args_smem_bytes(const WideArgs& a, int g, int a_used) {
  return multi_smem_bytes(g, a_used, a.k, true);
}

// Exclusive prefix sum of v over the block (and the total), `red` holding
// THREADS / 32 long longs of shared memory; it is free again on return.
__device__ __forceinline__ long long block_scan(long long v, long long* red, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int i = 0; i < THREADS / 32; ++i) {
    before += i < warp ? red[i] : 0;
    all += red[i];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// Append this lane's candidate (pred) to the shared list through one
// atomic per warp.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_append(bool pred, float v, int r, float* cand_v,
                                            int* cand_i, int* count) {
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (ballot == 0) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (pred) {
    const int s = base + __popc(ballot & ((1u << lane) - 1u));
    cand_v[s] = v;
    cand_i[s] = r;
  }
}

// Merge c <= 32 candidates (cand_*, any order) into the ascending top-k
// list by one warp, without a block barrier: the candidates sorted by a
// warp bitonic sort, then only the list's tail from the first candidate's
// place on is rewritten (through nxt_*).  The same list as
// `merge_candidates`: keys are unique.
__device__ __forceinline__ void merge_small(float* top_v, int* top_i, float* nxt_v, int* nxt_i,
                                            float* cand_v, int* cand_i, int c, int k) {
  const int lane = threadIdx.x & 31;
  float v = lane < c ? cand_v[lane] : CUDART_INF_F;
  int r = lane < c ? cand_i[lane] : INT_MAX;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float pv = __shfl_xor_sync(0xffffffffu, v, stride);
      const int pr = __shfl_xor_sync(0xffffffffu, r, stride);
      const bool lower = (lane & stride) == 0;        // keeps the smaller key
      const bool up = (lane & size) == 0 || size == 32;  // ascending half
      const bool mine_less = key_less(v, r, pv, pr);
      if (lower == up ? !mine_less : mine_less) {
        v = pv;
        r = pr;
      }
    }
  }
  cand_v[lane] = v;
  cand_i[lane] = r;
  __syncwarp();
  // first place a candidate takes: the list entries before it stay
  int lo = 0, hi = k;
  const float v0 = cand_v[0];
  const int r0 = cand_i[0];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(top_v[mid], top_i[mid], v0, r0)) lo = mid + 1; else hi = mid;
  }
  const int p0 = lo;
  for (int i = p0 + lane; i < k; i += 32) {
    const float tv = top_v[i];
    const int tr = top_i[i];
    int a = 0, b = c;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (key_less(cand_v[mid], cand_i[mid], tv, tr)) a = mid + 1; else b = mid;
    }
    if (i + a < k) {
      nxt_v[i + a - p0] = tv;
      nxt_i[i + a - p0] = tr;
    }
  }
  if (lane < c) {
    int a = p0, b = k;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (key_less(top_v[mid], top_i[mid], v, r)) a = mid + 1; else b = mid;
    }
    if (lane + a < k) {
      nxt_v[lane + a - p0] = v;
      nxt_i[lane + a - p0] = r;
    }
  }
  __syncwarp();
  for (int i = p0 + lane; i < k; i += 32) {
    top_v[i] = nxt_v[i - p0];
    top_i[i] = nxt_i[i - p0];
  }
}

// Merge c candidates into the list: by warp 0 when they are few and the
// list short (its tail is rewritten by one warp), else by the block
// (`merge_candidates`).  Every thread calls it; it ends with a barrier.
__device__ __forceinline__ void merge_any(float* top_v, int* top_i, float* nxt_v, int* nxt_i,
                                          float* cand_v, int* cand_i, int c, int k) {
  if (c <= 32 && k <= 256) {
    if (threadIdx.x < 32) merge_small(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
    __syncthreads();
  } else {
    merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
  }
}

// `merge_any` as a call: keeps the merge's registers out of a scan loop
// that needs its own (G = 4).
static __device__ __noinline__ void merge_any_call(float* top_v, int* top_i, float* nxt_v,
                                                   int* nxt_i, float* cand_v, int* cand_i, int c,
                                                   int k) {
  merge_any(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
}

// Shared-memory layout of a multi-table block.
struct MultiSmem {
  float* table;   // [A][G]
  float* top_v;   // [G][k]
  int* top_i;
  float* nxt_v;   // [k]
  int* nxt_i;
  float* cand_v;  // [PASS]
  int* cand_i;
};

template <int G>
__device__ __forceinline__ MultiSmem multi_smem(unsigned char* smem, int a_used, int k) {
  MultiSmem s;
  s.table = reinterpret_cast<float*>(smem);
  s.top_v = s.table + static_cast<size_t>(G) * a_used;
  s.top_i = reinterpret_cast<int*>(s.top_v + G * k);
  s.nxt_v = reinterpret_cast<float*>(s.top_i + G * k);
  s.nxt_i = reinterpret_cast<int*>(s.nxt_v + k);
  s.cand_v = reinterpret_cast<float*>(s.nxt_i + k);
  s.cand_i = reinterpret_cast<int*>(s.cand_v + PASS);
  return s;
}

// The in-place block's layout (`multi_smem_bytes` in place): no table.
template <int G>
__device__ __forceinline__ MultiSmem multi_smem_wide(unsigned char* smem, int k) {
  MultiSmem s;
  s.table = nullptr;
  s.top_v = reinterpret_cast<float*>(smem);
  s.top_i = reinterpret_cast<int*>(s.top_v + G * k);
  s.nxt_v = reinterpret_cast<float*>(s.top_i + G * k);
  s.nxt_i = reinterpret_cast<int*>(s.nxt_v + k);
  s.cand_v = reinterpret_cast<float*>(s.nxt_i + k);
  s.cand_i = reinterpret_cast<int*>(s.cand_v + PASS);
  return s;
}


// The G entries of address `addr` added to the G sums.  LDG: the table
// lies in device memory, interleaved by G; its G entries are one vector
// load through the read-only path (16 bytes for G = 4, 8 for G = 2).
template <int G, bool LDG = false>
__device__ __forceinline__ void multi_add(const float* table, uint32_t addr, float (&d)[G]) {
  if constexpr (LDG && G == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(table) + addr);
    d[0] = __fadd_rn(d[0], v.x);
    d[1] = __fadd_rn(d[1], v.y);
    d[2] = __fadd_rn(d[2], v.z);
    d[3] = __fadd_rn(d[3], v.w);
  } else if constexpr (LDG && G == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(table) + addr);
    d[0] = __fadd_rn(d[0], v.x);
    d[1] = __fadd_rn(d[1], v.y);
  } else if constexpr (LDG) {
    static_assert(G == 1, "the in-place block interleaves 1, 2 or 4 tables");
    d[0] = __fadd_rn(d[0], __ldg(table + addr));
  } else if constexpr (G == 4) {
    const float4 v = reinterpret_cast<const float4*>(table)[addr];
    d[0] = __fadd_rn(d[0], v.x);
    d[1] = __fadd_rn(d[1], v.y);
    d[2] = __fadd_rn(d[2], v.z);
    d[3] = __fadd_rn(d[3], v.w);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) d[g] = __fadd_rn(d[g], table[addr * G + g]);
  }
}

// 32-bit words of one row of a compile-time width (at least one).
template <typename CodeT, int WT>
__host__ __device__ constexpr int row_words() {
  return WT > 0 ? WT * static_cast<int>(sizeof(CodeT)) / 4 : 1;
}

// Load the codes of rows i = lo + j * THREADS + tid (j < R) below hi: all
// R rows' vector loads issued before any is used.  Rows past hi read 0.
template <typename CodeT, int WT, int R>
__device__ __forceinline__ void multi_load(const CodeT* __restrict__ codes, int lo, int hi,
                                           uint32_t (&wd)[R][row_words<CodeT, WT>()]) {
  constexpr int NW = row_words<CodeT, WT>();
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = lo + j * THREADS + static_cast<int>(threadIdx.x);
    const CodeT* row = codes + static_cast<size_t>(i) * WT;
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const uint4 v = i < hi ? __ldg(reinterpret_cast<const uint4*>(row) + q) : uint4{};
        wd[j][4 * q] = v.x;
        wd[j][4 * q + 1] = v.y;
        wd[j][4 * q + 2] = v.z;
        wd[j][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < NW / 2; ++q) {
        const uint2 v = i < hi ? __ldg(reinterpret_cast<const uint2*>(row) + q) : uint2{};
        wd[j][2 * q] = v.x;
        wd[j][2 * q + 1] = v.y;
      }
    }
  }
}

// Score rows [lo, hi) of the unit (R per thread, i = lo + j * THREADS +
// tid) into d, +inf for rows past hi: each address computed once and
// looked up in all G interleaved tables, every table's entries added in
// column order (SORT = false) or in ascending address order (SORT: the
// row's addresses sorted once for all G).  A compile-time width scores the
// words `multi_load` read; a runtime width (WT = 0) reads its codes here,
// element by element.  LDG: the table lies in device memory (`multi_add`).
template <typename CodeT, bool OFFSETS, int WT, int G, int R, bool SORT, bool LDG = false>
__device__ __forceinline__ void multi_score(const float* table, const CodeT* __restrict__ codes,
                                            int w_rt, int lo, int hi,
                                            const uint32_t (&wd)[R][row_words<CodeT, WT>()],
                                            float (&d)[R][G]) {
  static_assert(!(SORT && OFFSETS), "raw codes are already in table order");
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = lo + j * THREADS + static_cast<int>(threadIdx.x);
#pragma unroll
    for (int g = 0; g < G; ++g) d[j][g] = 0.f;
    if constexpr (WT > 0 && SORT) {
      uint32_t a[WT];
#pragma unroll
      for (int m = 0; m < WT; ++m) a[m] = word_elem<CodeT>(wd[j], m);
      sort_network<WT>(a);
#pragma unroll
      for (int m = 0; m < WT; ++m) multi_add<G, LDG>(table, a[m], d[j]);
    } else if constexpr (WT > 0) {
#pragma unroll
      for (int m = 0; m < WT; ++m)
        multi_add<G, LDG>(table, addr_of<OFFSETS>(word_elem<CodeT>(wd[j], m), m), d[j]);
    } else if (i < hi) {
      const CodeT* row = codes + static_cast<size_t>(i) * w_rt;
      if constexpr (SORT) {
        uint32_t la = 0;
        int lc = -1;
        for (int s = 0; s < w_rt; ++s)
          multi_add<G, LDG>(table, next_address(row, w_rt, la, lc), d[j]);
      } else {
        for (int m = 0; m < w_rt; ++m)
          multi_add<G, LDG>(table, addr_of<OFFSETS>(static_cast<uint32_t>(row[m]), m), d[j]);
      }
    }
    if (i >= hi) {
#pragma unroll
      for (int g = 0; g < G; ++g) d[j][g] = CUDART_INF_F;
    }
  }
}

// One pass without prefetch: load, then score.
template <typename CodeT, bool OFFSETS, int WT, int G, int R, bool SORT, bool LDG = false>
__device__ __forceinline__ void multi_pass(const float* table, const CodeT* __restrict__ codes,
                                           int w_rt, int lo, int hi, float (&d)[R][G]) {
  uint32_t wd[R][row_words<CodeT, WT>()];
  if constexpr (WT > 0) multi_load<CodeT, WT, R>(codes, lo, hi, wd);
  multi_score<CodeT, OFFSETS, WT, G, R, SORT, LDG>(table, codes, w_rt, lo, hi, wd, d);
}

// Smallest of each of the G values over the block, to every thread
// (`red` holds THREADS / 32 * G floats of shared memory).
template <int G>
__device__ __forceinline__ void block_min_g(float (&v)[G], float* red) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[g] = fminf(v[g], __shfl_xor_sync(0xffffffffu, v[g], o));
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) red[(threadIdx.x >> 5) * G + g] = v[g];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float r = red[g];
#pragma unroll
    for (int i = 1; i < THREADS / 32; ++i) r = fminf(r, red[i * G + g]);
    v[g] = r;
  }
  __syncthreads();
}

// Each warp's k-th smallest of its R * 32 values of each table (+inf when
// fewer are finite), to every lane: k rounds of a warp minimum, the lane
// that held it moving to its next value (its R values sorted first).
template <int G, int R>
__device__ __forceinline__ void warp_kth(const float (&d)[R][G], int k, float (&out)[G]) {
  float v[G][R];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < R; ++j) v[g][j] = d[j][g];
#pragma unroll
    for (int a = 0; a < R; ++a) {
#pragma unroll
      for (int b = 0; b + 1 < R - a; ++b) {
        const float lo = fminf(v[g][b], v[g][b + 1]), hi = fmaxf(v[g][b], v[g][b + 1]);
        v[g][b] = lo;
        v[g][b + 1] = hi;
      }
    }
  }
  const unsigned lane = threadIdx.x & 31;
  for (int round = 0; round < k; ++round) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float m = v[g][0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const unsigned owner = __ffs(__ballot_sync(0xffffffffu, v[g][0] == m)) - 1;
      if (lane == owner) {
#pragma unroll
        for (int j = 0; j + 1 < R; ++j) v[g][j] = v[g][j + 1];
        v[g][R - 1] = CUDART_INF_F;
      }
      out[g] = m;
    }
  }
}

// Merge the pass's candidates of every table whose `keep` is set: rows
// with d below that table's k-th taken at the start of the pass.  One
// block vote when no row qualifies; then the tables merge one after
// another, each collecting into the whole candidate buffer through the one
// counter `s_ncand`.  While a list is not yet full (its
// k-th +inf) and k <= 32, its candidates are also cut to d <= the smallest
// over warps of each warp's k-th smallest distance: that bounds the pass's
// own k-th from above, so no row of the merged top-k is lost, and about k
// rows per warp, not the whole pass, reach the merge.
template <int G, int R>
__device__ __forceinline__ void multi_collect(const MultiSmem& s, const float (&d)[R][G],
                                              const float (&kth)[G], const bool (&keep)[G],
                                              int lo, int k, int* s_ncand, float* s_red) {
  float cut[G];
  bool filling = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    cut[g] = CUDART_INF_F;
    filling |= keep[g] && kth[g] == CUDART_INF_F;
  }
  if (filling && k <= 32) {
    warp_kth<G, R>(d, k, cut);
    block_min_g<G>(cut, s_red);
  }
  auto pred = [&](int j, int g) { return keep[g] && d[j][g] < kth[g] && d[j][g] <= cut[g]; };
  bool any = false;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) any |= pred(j, g);
  }
  if (!__syncthreads_or(any)) return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    bool mine = false;
#pragma unroll
    for (int j = 0; j < R; ++j) mine |= pred(j, g);
    if (threadIdx.x == 0) *s_ncand = 0;
    if (!__syncthreads_or(mine)) continue;
#pragma unroll
    for (int j = 0; j < R; ++j)
      warp_append(pred(j, g), d[j][g], lo + j * THREADS + static_cast<int>(threadIdx.x),
                  s.cand_v, s.cand_i, s_ncand);
    __syncthreads();
    if constexpr (G == 1)
      merge_any(s.top_v, s.top_i, s.nxt_v, s.nxt_i, s.cand_v, s.cand_i, *s_ncand, k);
    else
      merge_any_call(s.top_v + g * k, s.top_i + g * k, s.nxt_v, s.nxt_i, s.cand_v, s.cand_i,
                     *s_ncand, k);
  }
}

// Scan tiles [ta, tz) of unit `un` into the block's G lists (ascending by
// (distance, row), rows numbered from the unit's row0).  The in-place
// block passes s.table pointing at the unit's tables in device memory.
template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT, typename Args>
__device__ void scan_run(const Args& a, const MultiSmem& s, const Unit& un, long long ta,
                         long long tz, int* s_ncand, float* s_red, float* s_bound) {
  constexpr int R = multi_rows<CodeT, WT>();
  constexpr int P = R * THREADS;
  constexpr bool LDG = kInPlace<Args>;
  const int tid = threadIdx.x;
  const int k = a.k, bn = a.block_n;
  const int W = WT > 0 ? WT : a.w;
  const int a_used = multi_table_width<OFFSETS, WT>(a.table_width, a.w);
  __syncthreads();  // the previous run's readers of the tables and lists are done
  if constexpr (!LDG) {
    const float* t0 = a.tables + static_cast<size_t>(un.q0) * a.table_width;
#pragma unroll 4
    for (int e = tid; e < a_used; e += THREADS) {
      float v[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        v[g] = g < un.nq ? __ldg(t0 + static_cast<size_t>(g) * a.table_width + e) : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) s.table[e * G + g] = v[g];
    }
  }
  for (int i = tid; i < G * k; i += THREADS) {
    s.top_v[i] = CUDART_INF_F;
    s.top_i[i] = -1;
  }
  if (tid < G)
    s_bound[tid] = tid < un.nq && a.bound != nullptr ? __ldg(a.bound + un.q0 + tid) : CUDART_INF_F;
  __syncthreads();
  bool live[G];
  bool bounded = false;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    live[g] = g < un.nq;
    bounded |= live[g] && s_bound[g] < CUDART_INF_F;
  }
  const CodeT* codes = static_cast<const CodeT*>(a.codes) + un.row0 * W;
  const int r0 = static_cast<int>(ta * bn);
  const int r1 = static_cast<int>(min(tz * static_cast<long long>(bn), static_cast<long long>(un.n_rows)));
  float d[R][G];
  float kth[G];
  if (!bounded) {
    if constexpr (WT > 0) {
      // the next pass's codes load while this pass is scored
      uint32_t cur[R][row_words<CodeT, WT>()], nxt[R][row_words<CodeT, WT>()];
      multi_load<CodeT, WT, R>(codes, r0, r1, cur);
      for (int lo = r0; lo < r1; lo += P) {
        // from r1 at most: row indices stay below r1 + P, inside int
        multi_load<CodeT, WT, R>(codes, min(lo + P, r1), r1, nxt);
#pragma unroll
        for (int g = 0; g < G; ++g) kth[g] = s.top_v[g * k + k - 1];
        multi_score<CodeT, OFFSETS, WT, G, R, SORT, LDG>(s.table, codes, W, lo, min(lo + P, r1), cur, d);
        multi_collect<G, R>(s, d, kth, live, lo, k, s_ncand, s_red);
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int q = 0; q < row_words<CodeT, WT>(); ++q) cur[j][q] = nxt[j][q];
        }
      }
    } else {
      for (int lo = r0; lo < r1; lo += P) {
#pragma unroll
        for (int g = 0; g < G; ++g) kth[g] = s.top_v[g * k + k - 1];
        multi_pass<CodeT, OFFSETS, WT, G, R, SORT, LDG>(s.table, codes, W, lo, min(lo + P, r1), d);
        multi_collect<G, R>(s, d, kth, live, lo, k, s_ncand, s_red);
      }
    }
    return;
  }
  for (int t0 = r0; t0 < r1; t0 += bn) {
    const int t1 = min(t0 + bn, r1);
    bool keep[G];
    float mn[G];
    if (t1 - t0 > P) {  // the tile spans passes: its minimum from a first sweep
#pragma unroll
      for (int g = 0; g < G; ++g) mn[g] = CUDART_INF_F;
      for (int lo = t0; lo < t1; lo += P) {
        multi_pass<CodeT, OFFSETS, WT, G, R, SORT, LDG>(s.table, codes, W, lo, min(lo + P, t1), d);
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int g = 0; g < G; ++g) mn[g] = fminf(mn[g], d[j][g]);
        }
      }
      block_min_g<G>(mn, s_red);
#pragma unroll
      for (int g = 0; g < G; ++g) keep[g] = live[g] && mn[g] <= s_bound[g];
    }
    for (int lo = t0; lo < t1; lo += P) {
#pragma unroll
      for (int g = 0; g < G; ++g) kth[g] = s.top_v[g * k + k - 1];
      multi_pass<CodeT, OFFSETS, WT, G, R, SORT, LDG>(s.table, codes, W, lo, min(lo + P, t1), d);
      if (t1 - t0 <= P) {  // one pass: the tile's minimum from the same sums
#pragma unroll
        for (int g = 0; g < G; ++g) {
          mn[g] = d[0][g];
#pragma unroll
          for (int j = 1; j < R; ++j) mn[g] = fminf(mn[g], d[j][g]);
        }
        block_min_g<G>(mn, s_red);
#pragma unroll
        for (int g = 0; g < G; ++g) keep[g] = live[g] && mn[g] <= s_bound[g];
      }
      multi_collect<G, R>(s, d, kth, keep, lo, k, s_ncand, s_red);
    }
  }
}

// B2 / B5's pair, unit u, over its tiles [ta, tz) (ascending rows) into the
// block's list, with the pruning of adc_topk_common.cuh: a tile is skipped
// iff lb >= this run's k-th or lb > min(b0, sq[q]) (and counted), a row
// kept only if d < k-th and d <= that bound, and sq[q] tightened by
// atomicMin from a full list after each tile.  A run's k-th over part of
// the pair's rows is never below the pair's, and the rows of its list come
// before the tile's, so whatever it drops lies strictly beyond the query's
// final k-th, as in the shared-memory block.  The run's counters are
// added to the unit's `counters`; the last of its n_runs runs to add (a
// ticket after __threadfence) writes their sums to `stats` and resets them.
template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__device__ void pair_run(const ScanWideArgs& a, const MultiSmem& s, int u, long long ta,
                         long long tz, int n_runs, int* s_ncand, float* s_red) {
  constexpr int R = multi_rows<CodeT, WT>();
  constexpr int P = R * THREADS;
  constexpr int NW = row_words<CodeT, WT>();
  __shared__ int s_skip;
  __shared__ float s_qb;
  const int tid = threadIdx.x;
  const int k = a.k, bn = a.block_n;
  const int W = WT > 0 ? WT : a.w;
  const int pair = __ldg(a.order + u);
  const int qi = __ldg(a.pair_q + pair);
  const float lb = __ldg(a.pair_lb + pair), b0 = __ldg(a.bound + qi);
  const int nv = __ldg(a.pair_nv + pair);
  const float* table = a.tables + static_cast<size_t>(__ldg(a.lut_row + pair)) * a.table_width;
  const CodeT* cdev =
      static_cast<const CodeT*>(a.codes) + static_cast<size_t>(pair / a.pairs_per_dev) * a.cap * W;
  __syncthreads();  // the previous run's readers of the list are done
  for (int i = tid; i < k; i += THREADS) {
    s.top_v[i] = CUDART_INF_F;
    s.top_i[i] = -1;
  }
  int n_skip = 0, n_avoid = 0;
  __syncthreads();
  const bool live[1] = {true};
  float d[R][1];
  float kth[1];
  for (long long t = ta; t < tz; ++t) {
    int row0;
    long long blk;
    if (a.pair_t0 != nullptr) {
      const long long q = __ldg(a.pair_t0 + pair) + t;
      row0 = __ldg(a.tile_row0 + q);
      blk = __ldg(a.tile_block + q);
    } else {
      row0 = static_cast<int>(t * bn);
      blk = __ldg(a.starts + pair) / bn + t;
    }
    if (tid == 0) {
      const float qb = fminf(b0, __ldcg(a.sq + qi));
      const int skip = (lb >= s.top_v[k - 1]) || (lb > qb);
      if (skip) {
        const int rows = min(max(nv - row0, 0), bn);
        n_skip += rows > 0;
        n_avoid += rows;
      }
      s_skip = skip;
      s_qb = qb;
    }
    __syncthreads();
    if (!s_skip) {
      const int n = min(bn, nv - row0);
      const float qb = s_qb;
      const CodeT* c = cdev + static_cast<size_t>(blk) * bn * W;
      // a row above the bound is no candidate: +inf is never below the k-th
      auto collect = [&](int lo) {
#pragma unroll
        for (int j = 0; j < R; ++j) d[j][0] = d[j][0] <= qb ? d[j][0] : CUDART_INF_F;
        multi_collect<1, R>(s, d, kth, live, row0 + lo, k, s_ncand, s_red);
      };
      if constexpr (WT > 0) {
        // the next pass's codes load while this pass is scored
        uint32_t cur[R][NW], nxt[R][NW];
        multi_load<CodeT, WT, R>(c, 0, n, cur);
        for (int lo = 0; lo < n; lo += P) {
          multi_load<CodeT, WT, R>(c, min(lo + P, n), n, nxt);
          kth[0] = s.top_v[k - 1];
          multi_score<CodeT, OFFSETS, WT, 1, R, SORT, true>(table, c, W, lo, min(lo + P, n), cur,
                                                            d);
          collect(lo);
#pragma unroll
          for (int j = 0; j < R; ++j) {
#pragma unroll
            for (int q = 0; q < NW; ++q) cur[j][q] = nxt[j][q];
          }
        }
      } else {
        for (int lo = 0; lo < n; lo += P) {
          kth[0] = s.top_v[k - 1];
          multi_pass<CodeT, OFFSETS, WT, 1, R, SORT, true>(table, c, W, lo, min(lo + P, n), d);
          collect(lo);
        }
      }
    }
    if (tid == 0) {
      const float kf = s.top_v[k - 1];
      if (kf < CUDART_INF_F) atomicMin(reinterpret_cast<int*>(a.sq + qi), __float_as_int(kf));
    }
    __syncthreads();
  }
  if (tid == 0) {
    int* c = a.counters + 3 * static_cast<size_t>(u);  // skipped, avoided, runs done
    if (n_skip) atomicAdd(c, n_skip);
    if (n_avoid) atomicAdd(c + 1, n_avoid);
    __threadfence();
    if (atomicAdd(c + 2, 1) == n_runs - 1) {
      __threadfence();
      a.stats[2 * static_cast<size_t>(pair)] = atomicExch(c, 0);
      a.stats[2 * static_cast<size_t>(pair) + 1] = atomicExch(c + 1, 0);
      c[2] = 0;
    }
  }
}

// Runs per first-level merge group of a unit: ceil(sqrt(runs)), so the
// merges left for the unit's last blocks take about 2 sqrt(runs) lists.
__device__ __forceinline__ int run_group(int n_runs) {
  int f = 1;
  while (f * f < n_runs) ++f;
  return f;
}

// Merge table g's lists of `count` scratch slots slot0, slot0 + stride, ...
// into the block's list g: every entry streams through the candidate
// merge, tested against the running k-th key first.
template <int G>
__device__ void merge_slots(const MultiArgs& a, const MultiSmem& s, int g, long long slot0,
                            int stride, int count, int* s_ncand) {
  const int tid = threadIdx.x;
  const int k = a.k;
  float* top_v = s.top_v + g * k;
  int* top_i = s.top_i + g * k;
  __syncthreads();
  for (int i = tid; i < k; i += THREADS) {
    top_v[i] = CUDART_INF_F;
    top_i[i] = -1;
  }
  __syncthreads();
  const int total = count * k;
  for (int c0 = 0; c0 < total; c0 += PASS) {
    const float kv = top_v[k - 1];
    const int ki = top_i[k - 1];
    if (tid == 0) *s_ncand = 0;
    __syncthreads();
    for (int j = tid; j < PASS; j += THREADS) {
      const int c = c0 + j;
      bool pred = false;
      float v = CUDART_INF_F;
      int r = -1;
      if (c < total) {
        const int list = c / k;
        const size_t at = (static_cast<size_t>(slot0 + static_cast<long long>(list) * stride) * G
                           + g) * k + (c - list * k);
        v = __ldcg(a.part_v + at);
        r = __ldcg(a.part_i + at);
        // (+inf, -1) lanes never pass: nothing is below the list's (+inf, -1)
        pred = key_less(v, r, kv, ki);
      }
      warp_append(pred, v, r, s.cand_v, s.cand_i, s_ncand);
    }
    __syncthreads();
    const int c = *s_ncand;
    if (c > 0) merge_any(top_v, top_i, s.nxt_v, s.nxt_i, s.cand_v, s.cand_i, c, k);
  }
}

// Store the block's nq lists: to the output rows q0.. (slot < 0) or to a
// scratch slot.
template <int G>
__device__ __forceinline__ void store_lists(const MultiArgs& a, const MultiSmem& s, const Unit& un,
                                            long long slot) {
  const int k = a.k;
  for (int i = threadIdx.x; i < un.nq * k; i += THREADS) {
    if (slot < 0) {
      a.out_v[static_cast<size_t>(un.q0) * k + i] = s.top_v[i];
      a.out_i[static_cast<size_t>(un.q0) * k + i] = s.top_i[i];
    } else {
      a.part_v[static_cast<size_t>(slot) * G * k + i] = s.top_v[i];
      a.part_i[static_cast<size_t>(slot) * G * k + i] = s.top_i[i];
    }
  }
}

// Whether this block is the last of `n` to arrive at ticket t (after its
// stores, fenced); the last one resets the ticket for the next call.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n, int* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *s_last = atomicAdd(ticket, 1) == n - 1;
    if (*s_last) *ticket = 0;
  }
  __syncthreads();
  if (*s_last) __threadfence();
  return *s_last;
}

// Finish the block's run of unit u: a unit of one run writes its lists to
// the output.  Otherwise the run's lists go to scratch slot b + u; the
// last block of each group of `run_group` consecutive runs merges the
// group's lists into the group's first slot, and the last group to finish
// merges the groups' lists into the output.  Tickets: u for the unit,
// n_units + slot for a group.
template <int G>
__device__ void finish_run(const MultiArgs& a, const MultiSmem& s, const Unit& un, int u,
                           long long first, long long last, int* s_ncand, int* s_last) {
  if (first == last) {
    store_lists<G>(a, s, un, -1);
    return;
  }
  const long long b = blockIdx.x;
  const int n_runs = static_cast<int>(last - first + 1);
  const int f = run_group(n_runs);
  const int g0 = static_cast<int>(b - first) / f * f;
  const int gn = min(f, n_runs - g0);
  const int n_groups = (n_runs + f - 1) / f;
  if (gn > 1) {
    store_lists<G>(a, s, un, b + u);
    if (!last_to_arrive(a.tickets + a.n_units + first + g0 + u, gn, s_last)) return;
    for (int g = 0; g < un.nq; ++g) merge_slots<G>(a, s, g, first + g0 + u, 1, gn, s_ncand);
    __syncthreads();
  }
  if (n_groups == 1) {
    store_lists<G>(a, s, un, -1);
    return;
  }
  store_lists<G>(a, s, un, first + g0 + u);
  if (!last_to_arrive(a.tickets + u, n_groups, s_last)) return;
  for (int g = 0; g < un.nq; ++g) merge_slots<G>(a, s, g, first + u, f, n_groups, s_ncand);
  __syncthreads();
  store_lists<G>(a, s, un, -1);
}

// The block's whole work: total the units' tiles, take tiles
// [b * T / nb, (b + 1) * T / nb), scan and finish every run in them.
template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT, typename Args>
__device__ void topk_multi(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_start[THREADS];
  __shared__ int s_cnt[THREADS];
  __shared__ long long s_red64[THREADS / 32];
  __shared__ float s_red[THREADS / 32 * G];
  __shared__ float s_bound[G];
  __shared__ int s_ncand, s_last;
  const int tid = threadIdx.x;
  const int a_used = multi_table_width<OFFSETS, WT>(a.table_width, a.w);
  const MultiSmem s = multi_smem<G>(smem, a_used, a.k);
  const long long bn = a.block_n;

  long long part = 0;
  for (int u = tid; u < a.n_units; u += THREADS)
    part += (unit_at<G>(a, u).n_rows + bn - 1) / bn;
  long long T;
  block_scan(part, s_red64, &T);
  const long long nb = min(static_cast<long long>(gridDim.x), T);
  const long long b = blockIdx.x;
  if (b >= nb) return;
  const long long tb = b * T / nb, te = (b + 1) * T / nb;

  long long base = 0;  // first tile of the chunk of units
  for (int c0 = 0; c0 < a.n_units && base < te; c0 += THREADS) {
    const int u = c0 + tid;
    const int cnt = u < a.n_units ? static_cast<int>((unit_at<G>(a, u).n_rows + bn - 1) / bn) : 0;
    long long chunk;
    s_start[tid] = base + block_scan(cnt, s_red64, &chunk);
    s_cnt[tid] = cnt;
    __syncthreads();
    const int n_here = min(THREADS, a.n_units - c0);
    for (int j = 0; j < n_here; ++j) {
      const long long start = s_start[j];
      const int count = s_cnt[j];
      if (start >= te) break;
      if (count == 0 || start + count <= tb) continue;
      const Unit un = unit_at<G>(a, c0 + j);
      const long long ta = max(tb, start) - start, tz = min(te, start + count) - start;
      scan_run<CodeT, OFFSETS, WT, G, SORT>(a, s, un, ta, tz, &s_ncand, s_red, s_bound);
      const long long first = ((start + 1) * nb - 1) / T;
      const long long last = ((start + count) * nb - 1) / T;
      finish_run<G>(a, s, un, c0 + j, first, last, &s_ncand, &s_last);
    }
    base += chunk;
    __syncthreads();
  }
}

// Tiles of in-place unit u, as the launcher's plan kernel counts them:
// B6 / B7's rows cut at block_n, B2 / B5's `pair_tiles`.
__device__ __forceinline__ long long inplace_tiles(const WideArgs& a, int u) {
  return (unit_at<1>(a, u).n_rows + a.block_n - 1) / a.block_n;
}
__device__ __forceinline__ long long inplace_tiles(const ScanWideArgs& a, int u) {
  return pair_tiles(a, u);
}

// The in-place block's whole work (B6 / B7's units of G tables, B2 / B5's
// pairs): tiles [b * T / nb, (b + 1) * T / nb) of the units' T tiles, its
// first unit found by a binary search of `ustart` (B6 over one code array:
// unit u starts at tile u * ceil(n_rows / block_n)), and the run of every
// unit they cover, as `topk_multi` cuts the shared block's units (and the
// select kernels theirs), finished through the same ticket tree.  A block
// reads O(log units) starts where `topk_multi` totals every unit's tiles
// in every block.
template <typename CodeT, bool OFFSETS, int WT, int G, bool SORT, typename Args>
__device__ void topk_inplace(const Args& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_red[THREADS / 32 * G];
  __shared__ float s_bound[G];
  __shared__ int s_ncand, s_last;
  const MultiSmem s = multi_smem_wide<G>(smem, a.k);
  const int a_used = multi_table_width<OFFSETS, WT>(a.table_width, a.w);
  const long long per = (static_cast<long long>(a.n_rows) + a.block_n - 1) / a.block_n;
  auto first_tile = [&](int u) {
    return a.ustart != nullptr ? __ldg(a.ustart + u) : u * per;
  };
  const long long T = first_tile(a.n_units);
  const long long nb = min(static_cast<long long>(gridDim.x), T);
  const long long b = blockIdx.x;
  if (b >= nb) return;
  const long long tb = b * T / nb, te = (b + 1) * T / nb;
  int lo = 0, hi = a.n_units;  // the unit of tile tb: the last u starting at or before it
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first_tile(mid) <= tb) lo = mid; else hi = mid;
  }
  for (int u = lo; u < a.n_units; ++u) {
    const long long start = first_tile(u);
    if (start >= te) break;
    const long long count = first_tile(u + 1) - start;
    if (count == 0) continue;
    const long long ta = max(tb, start) - start, tz = min(te, start + count) - start;
    const long long first = ((start + 1) * nb - 1) / T;
    const long long last = ((start + count) * nb - 1) / T;
    if constexpr (kPairUnits<Args>) {
      static_assert(G == 1, "B2 / B5's pairs are units of one table");
      pair_run<CodeT, OFFSETS, WT, SORT>(a, s, u, ta, tz, static_cast<int>(last - first + 1),
                                         &s_ncand, s_red);
      const Unit un{0, 0, __ldg(a.order + u), 1};  // the pair's output row
      finish_run<1>(a, s, un, u, first, last, &s_ncand, &s_last);
    } else {
      const Unit un = unit_at<G>(a, u);
      MultiSmem su = s;  // the unit's tables where they lie, never written
      su.table = const_cast<float*>(G == 1 ? a.tables + static_cast<size_t>(un.q0) * a.table_width
                                           : a.ilv + static_cast<size_t>(u) * a_used * G);
      scan_run<CodeT, OFFSETS, WT, G, SORT>(a, su, un, ta, tz, &s_ncand, s_red, s_bound);
      finish_run<G>(a, s, un, u, first, last, &s_ncand, &s_last);
    }
  }
}

// Set the dynamic shared-memory limit of `kernel` to what a launch asks
// (the static part sits beside it, so even 48 KB may need the raise).
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel, typename Args>
inline int launch_multi_kernel(Kernel kernel, const Args& a, int g, int n_blocks, int a_used,
                               cudaStream_t stream) {
  const size_t smem = args_smem_bytes(a, g, a_used);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
inline int multi_blocks_per_sm(Kernel kernel, int g, int a_used, int k, bool in_place = false) {
  const size_t smem = multi_smem_bytes(g, a_used, k, in_place);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // namespace repro_adc
