// Kernels B2, B5, B6 and B7 past the shared-memory blocks' k (k > 4096,
// the "select" plans of kernels/adc_topk.py `scan_plan` / `topk_plan`): the
// k-th key of each unit is selected once, then exactly its k winners are
// sorted.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_tiles_kernel` (B2),
//           `adc_topk_windows_kernel` (B5), `adc_topk_kernel` (B6) and
//           `adc_topk_pairs_kernel` (B7) where k is past the shared-memory
//           block's range: the Pallas kernels keep a (k,) scratch of any k
//           in VMEM and merge every tile into it.
//
// Units.  B6 / B7: their units (adc_topk_multi.cuh `unit_at`: one table
// a unit, B7's n_valid read on the card, B6's finite bound skipping a whole
// tile whose smallest distance is above it).  B2 / B5: their filled pairs
// (`ScanSelectArgs`), in the launch order the wrapper gives; a pair's table
// is row lut_row[pair] of the (R, A) tables, its tiles B2's run of the tile
// queue (`tile_block` / `tile_row0`, ascending rows) or B5's blocks 0 ..
// ceil(n_valid / block_n) - 1 of its window from `starts`.  The plan step
// writes each unit's first tile (`ustart`, the units' tile counts summed);
// the T tiles are cut over nb = min(grid, T) blocks, block b taking
// [b * T / nb, (b + 1) * T / nb), so a 258k-row pair runs on many blocks
// (kernels/adc_topk.py `run_plan` is the twin).  Every row is scored with
// the same `multi_load` / `multi_score` sums as the shared-memory blocks
// (__fadd_rn in column or address order; `adc_row`'s sums), so each
// distance is the same bits.  A distance d becomes a 32-bit key that orders
// as d does (the sign bit set on d >= 0, every bit flipped on d < 0); +inf
// and NaN are no candidate (the merging blocks never took them either).
//
// Passes (one launch each, on the caller's stream; `run_chain`):
//   plan  the units' first tiles (and B2 / B5's bounds at the start, sq0).
//   hist0, hist1  score every run and count its candidates' keys by one
//        digit in a shared-memory histogram (bits 31..21, then 20..10 of
//        the keys whose first digit is the k-th's).  A unit whose tiles lie
//        in one block resolves the digit there; a unit cut over blocks adds
//        to the histogram of its first block's slot in device memory, and
//        the last block to finish its runs (an atomic ticket after
//        __threadfence, as the merge tree of adc_topk_multi.cuh) resolves
//        it: the bucket of keys that share the k-th's 22 bits, the count c
//        of keys below it, and the rank still needed in it.  A unit with at
//        most k candidates takes all of them and stops selecting.
//   compact  every key below the bucket (or every candidate) goes to the
//        unit's output row at a position from one atomic counter, and the
//        bucket's (key, row) pairs to the unit's part of a shared bucket
//        pool (taken when the digit resolves: at most SEL_BUCKET rows, while
//        the pool lasts; the rows near the k-th, a few hundred on the
//        smoke's data).
//   bucket  one block a unit sorts its bucket by (key, row) and writes the
//        k - c smallest at c onwards.
// A bucket past SEL_BUCKET rows (many rows tied within 2^-13 of the k-th),
// or one the pool cannot hold, takes three more passes over the codes
// instead, launched in every call and empty for the other units:
//   hist2  the last 10 bits, to the k-th key K* itself and the ties at it;
//   compact2  every key below K* (and every tie where all are taken) as
//        above; where not, each run counts its ties;
//   ties  a run adds the tie counts of the unit's earlier runs (its rows
//        come after theirs), numbers its own ties in row order (a ballot
//        per warp, the warps' counts through shared memory) and writes the
//        first k - c of the unit at c + rank.
// So the winners are the k smallest (distance, row) keys, ties at the k-th
// broken by the lower row, the repo's order, however many rows tie.
//   sort  one block a unit sorts its row's winners by (key, row) as 64-bit
//        keys, a bitonic network held in registers (`sort_steps`; up to
//        SORT_CHUNK keys, a larger k runs its strides of SORT_CHUNK and
//        more in device memory), and pads with (+inf, -1) as the plain
//        versions do.
// Rows are scored again in every pass rather than kept: scratch is a state
// a unit, a histogram a block, a tie count a run, each unit's first tile
// and the bucket pool (kernels/adc_topk.py `select_scratch`); the k winners
// are written into the output itself.
//
// B2 / B5's pruning (the contract of adc_topk_common.cuh: whatever is
// dropped lies strictly beyond the query's final k-th).  The three digit
// passes of a unit must score the same rows, or their ranks would not add
// up, so they read a bound fixed for the call: qb0 = min(bound[q], sq0[q]),
// the pair skipped whole when its lower bound lb > qb0 and a row a
// candidate only if d <= qb0.  Each digit resolved tightens sq[q] by
// atomicMin with the largest key its prefix allows (K* itself after the
// third): at least k of the pair's rows lie at or below it, so the query's
// final k-th does too.  The compactions and the last two steps read the
// tightened sq: a pair with lb > min(bound[q], sq[q]) is skipped whole (its
// tiles counted in `stats`), and the sort drops every winner with d above
// that bound.  (A select resolves the pair's own K*, and lb <= every
// distance of the pair, so `lb >= k-th` -- the shared block's running test,
// sound there because that k-th comes from lower rows -- has nothing to
// skip here: a tile before K*'s row can hold a winner tied with K*.)
//
// What bounds it on an H100: the code bytes, read once a pass (three
// passes), and the table lookups of the scoring; then the sort of k keys
// by one block a unit.

#include <type_traits>

#include "adc_topk_multi.cuh"

namespace {

using namespace repro_adc;

constexpr int SEL_BINS = 2048;              // histogram bins of a digit (11 bits)
constexpr int SEL_STATE = 12;               // int32 fields of a unit's state
constexpr int SEL_BUCKET = 8192;            // rows a unit's bucket may hold
constexpr int SEL_POOL_PER_UNIT = 256;      // bucket pool rows a unit adds
constexpr unsigned SEL_EXCL = 0xffffffffu;  // the key of a row that is no candidate
constexpr int SORT_THREADS = 1024;
constexpr int SORT_CHUNK = 16384;           // keys a sort block holds (128 KB)

// a unit's state in device memory (zeroed by the launcher)
enum {
  ST_MODE, ST_PREFIX, ST_NEED, ST_LESS, ST_TIES, ST_WRITTEN, ST_NOUT, ST_TICKET, ST_BUCKET,
  ST_BOFF, ST_DROP
};
// ST_MODE: selecting, every candidate wins, K* resolved, or the bucket
// buffered after two digits (ST_TIES then its rows, from pool row ST_BOFF)
enum { M_SELECT = 0, M_ALL = 1, M_KTH = 2, M_BUCKET = 3 };
// phases: 0-2 the histogram digits, then
enum { PH_COMPACT2 = 3, PH_TIES = 4, PH_COMPACT = 5 };

struct SelectArgs : MultiArgs {
  int gtab;                    // the table read where it lies
  int phase;                   // 0-2 histogram digit, PH_COMPACT, PH_COMPACT2, PH_TIES
  int* state;                  // (n_units, SEL_STATE)
  unsigned* hist;              // (n_blocks, SEL_BINS): a split unit's, at its first block; zero
  int* tiecnt;                 // (n_blocks + n_units,): ties of run slot b + u
  unsigned long long* bucket;  // (pool_cap,) (key, row) rows of the units' buckets
  int* pool_used;              // pool rows taken
  long long pool_cap;
  long long* ustart;           // (n_units + 1,): the first tile of each unit, then T
};

// B2 / B5's units and bounds: unit u is pair order[u].
struct ScanSelectArgs : SelectArgs {
  const int* lut_row;     // (P_all,) table row of each pair
  const int* order;       // (n_units,)
  const int* pair_t0;     // B2: (P_all,) the pair's tiles [t0, t1) of the queue; null for B5
  const int* pair_t1;
  const int* tile_block;  // B2: (ndev * T_queue,)
  const int* tile_row0;
  const int* starts;      // B5: (P_all,) the window's first row (block-aligned)
  const int* pair_nv;     // (P_all,) valid rows
  const int* pair_q;      // (P_all,)
  const float* pair_lb;   // (P_all,)
  float* sq;              // (Q,) the queries' shared bound (`bound` holds b0)
  float* sq0;             // (Q,) sq at the call's start
  int* stats;             // (P_all, 2) [tiles skipped, rows avoided]
  long long cap;          // code rows a device
  int pairs_per_dev;
};

template <typename Args>
constexpr bool kPairs = std::is_same<Args, ScanSelectArgs>::value;

__device__ __forceinline__ unsigned order_bits(float d) {
  const unsigned x = __float_as_uint(d);
  return x & 0x80000000u ? ~x : x | 0x80000000u;
}
__device__ __forceinline__ unsigned order_key(float d) {
  return d < CUDART_INF_F ? order_bits(d) : SEL_EXCL;  // +inf, NaN: no candidate
}
__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}
// digits of the key, most significant first: bits 31..21, 20..10, 9..0
__device__ __forceinline__ int digit_shift(int p) { return p == 0 ? 21 : (p == 1 ? 10 : 0); }

// Add one to bin `bin` of the shared histogram for every lane with `hit`:
// lanes of one bin are counted by one atomic (warp-aggregated).
__device__ __forceinline__ void hist_add(unsigned* h, bool hit, unsigned bin) {
  const unsigned act = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned peers = __match_any_sync(act, bin);
    if (static_cast<int>(threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(h + bin, __popc(peers));
  }
}

// Tiles of unit u: B6 / B7's rows cut at block_n; B2 / B5's pair, none
// without a table.
__device__ __forceinline__ long long unit_tiles(const SelectArgs& a, int u) {
  return (unit_at<1>(a, u).n_rows + a.block_n - 1) / a.block_n;
}
__device__ __forceinline__ long long unit_tiles(const ScanSelectArgs& a, int u) {
  const int p = __ldg(a.order + u);
  if (__ldg(a.lut_row + p) < 0) return 0;
  if (a.pair_t0 != nullptr) return max(__ldg(a.pair_t1 + p) - __ldg(a.pair_t0 + p), 0);
  return (max(__ldg(a.pair_nv + p), 0) + a.block_n - 1) / a.block_n;
}

// The unit's table row, and its output row (B6: grouped units' q0, else
// the unit; B7: the pair; B2 / B5: the pair).
__device__ __forceinline__ int table_row(const SelectArgs& a, int u) { return unit_at<1>(a, u).q0; }
__device__ __forceinline__ int table_row(const ScanSelectArgs& a, int u) {
  return __ldg(a.lut_row + __ldg(a.order + u));
}

// B2 / B5: the bound the digit passes read (fixed for the call) and the
// one the compactions read (tightened by the resolved digits).
__device__ __forceinline__ float fixed_bound(const ScanSelectArgs& a, int qi) {
  return fminf(__ldg(a.bound + qi), __ldcg(a.sq0 + qi));
}
__device__ __forceinline__ float live_bound(const ScanSelectArgs& a, int qi) {
  return fminf(__ldg(a.bound + qi), __ldcg(a.sq + qi));
}

// The plan step, one block: ustart[u] = the tiles of units 0 .. u-1,
// ustart[n_units] = T; B2 / B5 also keep sq as the call found it.
template <typename Args>
__global__ void __launch_bounds__(THREADS) adc_topk_select_plan_kernel(const Args a) {
  __shared__ long long s_red64[THREADS / 32];
  long long base = 0;
  for (int c0 = 0; c0 < a.n_units; c0 += THREADS) {
    const int u = c0 + static_cast<int>(threadIdx.x);
    long long chunk;
    const long long before = block_scan(u < a.n_units ? unit_tiles(a, u) : 0, s_red64, &chunk);
    if (u < a.n_units) a.ustart[u] = base + before;
    base += chunk;
  }
  if (threadIdx.x == 0) a.ustart[a.n_units] = base;
  if constexpr (kPairs<Args>) {
    for (int q = threadIdx.x; q < a.n_q; q += THREADS) a.sq0[q] = a.sq[q];
  }
}

// Score rows [ta * bn, min(tz * bn, n_rows)) of B6 / B7's unit u and hand
// each pass's keys to visit(lo, key[R]) (row lo + j * THREADS + tid in
// key[j]; SEL_EXCL past the run).  With a finite bound a tile whose
// smallest distance is above it is not visited (`scan_run`'s rule: that
// minimum from the same sums when the tile fits one pass, else from a first
// sweep).  Every thread calls it and every call of visit.
template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Visit>
__device__ void unit_scan(const SelectArgs& a, const float* table, int u, long long ta,
                          long long tz, float* s_red, Visit&& visit) {
  constexpr int R = multi_rows<CodeT, WT>();
  constexpr int P = R * THREADS;
  constexpr int NW = row_words<CodeT, WT>();
  const Unit un = unit_at<1>(a, u);
  const float bnd = a.bound != nullptr ? __ldg(a.bound + un.q0) : CUDART_INF_F;
  const int bn = a.block_n;
  const int W = WT > 0 ? WT : a.w;
  const CodeT* codes = static_cast<const CodeT*>(a.codes) + un.row0 * W;
  const int r0 = static_cast<int>(ta * bn);
  const int r1 = static_cast<int>(min(tz * static_cast<long long>(bn),
                                      static_cast<long long>(un.n_rows)));
  float d[R][1];
  unsigned key[R];
  if (!(bnd < CUDART_INF_F)) {
    if constexpr (WT > 0) {
      // the next pass's codes load while this pass is scored
      uint32_t cur[R][NW], nxt[R][NW];
      multi_load<CodeT, WT, R>(codes, r0, r1, cur);
      for (int lo = r0; lo < r1; lo += P) {
        multi_load<CodeT, WT, R>(codes, min(lo + P, r1), r1, nxt);
        multi_score<CodeT, OFFSETS, WT, 1, R, SORT>(table, codes, W, lo, min(lo + P, r1), cur, d);
#pragma unroll
        for (int j = 0; j < R; ++j) key[j] = order_key(d[j][0]);
        visit(lo, key);
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int q = 0; q < NW; ++q) cur[j][q] = nxt[j][q];
        }
      }
    } else {
      for (int lo = r0; lo < r1; lo += P) {
        multi_pass<CodeT, OFFSETS, WT, 1, R, SORT>(table, codes, W, lo, min(lo + P, r1), d);
#pragma unroll
        for (int j = 0; j < R; ++j) key[j] = order_key(d[j][0]);
        visit(lo, key);
      }
    }
    return;
  }
  for (int t0 = r0; t0 < r1; t0 += bn) {
    const int t1 = min(t0 + bn, r1);
    bool keep = true;
    float mn[1];
    if (t1 - t0 > P) {  // the tile spans passes: its minimum from a first sweep
      mn[0] = CUDART_INF_F;
      for (int lo = t0; lo < t1; lo += P) {
        multi_pass<CodeT, OFFSETS, WT, 1, R, SORT>(table, codes, W, lo, min(lo + P, t1), d);
#pragma unroll
        for (int j = 0; j < R; ++j) mn[0] = fminf(mn[0], d[j][0]);
      }
      block_min_g<1>(mn, s_red);
      keep = mn[0] <= bnd;
    }
    for (int lo = t0; lo < t1; lo += P) {
      multi_pass<CodeT, OFFSETS, WT, 1, R, SORT>(table, codes, W, lo, min(lo + P, t1), d);
      if (t1 - t0 <= P) {  // one pass: the tile's minimum from the same sums
        mn[0] = d[0][0];
#pragma unroll
        for (int j = 1; j < R; ++j) mn[0] = fminf(mn[0], d[j][0]);
        block_min_g<1>(mn, s_red);
        keep = mn[0] <= bnd;
      }
      if (!keep) continue;  // the same for every thread
#pragma unroll
      for (int j = 0; j < R; ++j) key[j] = order_key(d[j][0]);
      visit(lo, key);
    }
  }
}

// The same for B2 / B5's pair u: its tiles [ta, tz), each up to block_n
// rows of its own code block (row numbers from the tile's row0), all at
// the fixed bound qb0: nothing when the pair's lb > qb0, else a row's key
// only when d <= qb0.  Passes follow one another across tiles, the next
// one's codes loading while one is scored.
template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Visit>
__device__ void unit_scan(const ScanSelectArgs& a, const float* table, int u, long long ta,
                          long long tz, float*, Visit&& visit) {
  constexpr int R = multi_rows<CodeT, WT>();
  constexpr int P = R * THREADS;
  constexpr int NW = row_words<CodeT, WT>();
  const int pair = __ldg(a.order + u);
  const float qb = fixed_bound(a, __ldg(a.pair_q + pair));
  if (__ldg(a.pair_lb + pair) > qb) return;
  const int bn = a.block_n;
  const int W = WT > 0 ? WT : a.w;
  const int nv = __ldg(a.pair_nv + pair);
  const CodeT* cdev =
      static_cast<const CodeT*>(a.codes) + static_cast<size_t>(pair / a.pairs_per_dev) * a.cap * W;
  // the cursor: pass [lo, lo + P) of tile t (rows [0, n) from row0, codes c)
  long long t = ta - 1;
  int lo = -P, n = 0, row0 = 0;
  const CodeT* c = cdev;
  auto next = [&]() {  // to the run's next pass with rows, or t == tz
    lo += P;
    while (lo >= n && ++t < tz) {
      long long blk;
      if (a.pair_t0 != nullptr) {
        const long long q = __ldg(a.pair_t0 + pair) + t;
        row0 = __ldg(a.tile_row0 + q);
        blk = __ldg(a.tile_block + q);
      } else {
        row0 = static_cast<int>(t * bn);
        blk = __ldg(a.starts + pair) / bn + t;
      }
      n = min(bn, nv - row0);
      lo = 0;
      c = cdev + static_cast<size_t>(blk) * bn * W;
    }
  };
  float d[R][1];
  unsigned key[R];
  auto emit = [&](int base) {
#pragma unroll
    for (int j = 0; j < R; ++j) key[j] = d[j][0] <= qb ? order_key(d[j][0]) : SEL_EXCL;
    visit(base, key);
  };
  next();
  if constexpr (WT > 0) {
    uint32_t cur[R][NW], nxt[R][NW];
    if (t < tz) multi_load<CodeT, WT, R>(c, lo, n, cur);
    while (t < tz) {
      const CodeT* cc = c;
      const int clo = lo, chi = min(lo + P, n), cbase = row0 + lo;
      next();
      if (t < tz) multi_load<CodeT, WT, R>(c, lo, n, nxt);
      multi_score<CodeT, OFFSETS, WT, 1, R, SORT>(table, cc, W, clo, chi, cur, d);
      emit(cbase);
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int q = 0; q < NW; ++q) cur[j][q] = nxt[j][q];
      }
    }
  } else {
    for (; t < tz; next()) {
      multi_pass<CodeT, OFFSETS, WT, 1, R, SORT>(table, c, W, lo, min(lo + P, n), d);
      emit(row0 + lo);
    }
  }
}

// The block's shared scratch beside the table.
struct SelShared {
  unsigned* hist;      // [SEL_BINS]
  long long* red64;    // [THREADS / 32]
  float* red;          // [THREADS / 32]
  int* rank;           // [R][THREADS / 32]
  int* count;
  int* last;
};

// Resolve pass p's digit of unit u from histogram h (the block's own in
// shared memory, or a split unit's slot in device memory, zeroed here for
// the next pass): the bin where the count from the smallest key reaches
// the rank still needed.  B2 / B5 tighten their query's sq with the
// largest key the digits so far allow.
template <typename Args>
__device__ void resolve(const Args& a, int u, int p, unsigned* h, bool global,
                        const SelShared& sh) {
  int* st = a.state + static_cast<size_t>(u) * SEL_STATE;
  const int tid = threadIdx.x;
  constexpr int PER = SEL_BINS / THREADS;
  const int n_bins = p == 2 ? 1024 : SEL_BINS;
  unsigned c[PER];
  long long sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int bin = tid * PER + i;
    c[i] = bin < n_bins ? (global ? __ldcg(h + bin) : h[bin]) : 0u;
    if (global) h[bin] = 0u;
    sum += c[i];
  }
  // read before the scan's barriers: the one thread below rewrites it
  const long long need = p == 0 ? a.k : st[ST_NEED];
  long long total;
  const long long before = block_scan(sum, sh.red64, &total);
  if (p == 0 && total <= need) {
    if (tid == 0) {
      st[ST_MODE] = M_ALL;
      st[ST_NOUT] = static_cast<int>(total);
    }
    return;
  }
  if (before < need && need <= before + sum) {  // exactly one thread
    long long cum = before;
    int i = 0;
    while (cum + c[i] < need) cum += c[i++];
    const unsigned prefix = static_cast<unsigned>(p == 0 ? 0 : st[ST_PREFIX]) |
                            (static_cast<unsigned>(tid * PER + i) << digit_shift(p));
    st[ST_PREFIX] = static_cast<int>(prefix);
    st[ST_NEED] = static_cast<int>(need - cum);
    st[ST_LESS] = static_cast<int>((p == 0 ? 0 : st[ST_LESS]) + cum);
    if (p == 1 && c[i] <= SEL_BUCKET) {
      const int off = atomicAdd(a.pool_used, static_cast<int>(c[i]));
      if (off + static_cast<long long>(c[i]) <= a.pool_cap) {
        st[ST_BOFF] = off;
        st[ST_TIES] = static_cast<int>(c[i]);
        st[ST_NOUT] = a.k;
        st[ST_MODE] = M_BUCKET;
      }
    }
    if (p == 2) {
      st[ST_TIES] = static_cast<int>(c[i]);
      st[ST_NOUT] = a.k;
      st[ST_MODE] = M_KTH;
    }
    if constexpr (kPairs<Args>) {
      const float v = key_value(prefix | ((1u << digit_shift(p)) - 1u));
      const int qi = __ldg(a.pair_q + __ldg(a.order + u));
      if (v >= 0.f && v < CUDART_INF_F)  // non-negative floats order as their bits
        atomicMin(reinterpret_cast<int*>(a.sq + qi), __float_as_int(v));
    }
  }
}

// The block's run of unit u (tiles [ta, tz), rows numbered from the unit's
// first) in this launch's phase; its runs are those of blocks first ..
// last.
template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
__device__ void select_run(const Args& a, float* s_table, const SelShared& sh, int u,
                           long long ta, long long tz, long long first, long long last,
                           int out_row) {
  constexpr int R = multi_rows<CodeT, WT>();
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int phase = a.phase;
  int* st = a.state + static_cast<size_t>(u) * SEL_STATE;
  const int mode = st[ST_MODE];
  const unsigned kstar = static_cast<unsigned>(st[ST_PREFIX]);
  const int need = st[ST_NEED], ties = st[ST_TIES], less = st[ST_LESS];
  const bool partial = mode == M_KTH && need < ties;
  bool runs = partial;  // PH_TIES
  if (phase == 0) runs = true;
  if (phase == 1 || phase == 2) runs = mode == M_SELECT;
  if (phase == PH_COMPACT) runs = mode == M_ALL || mode == M_BUCKET;
  if (phase == PH_COMPACT2) runs = mode == M_KTH;
  if (!runs) return;
  if constexpr (kPairs<Args>) {
    // a compaction skips a pair whose every row lies above the tightened bound
    const int pair = __ldg(a.order + u);
    if (phase >= PH_COMPACT2 && __ldg(a.pair_lb + pair) > live_bound(a, __ldg(a.pair_q + pair))) {
      if (tid == 0) st[ST_DROP] = 1;
      return;
    }
  }
  const long long slot = static_cast<long long>(blockIdx.x) + u;
  long long base = 0;  // ties in the unit's earlier runs
  if (phase == PH_TIES) {
    long long part = 0;
    for (long long s = first + u + tid; s < slot; s += THREADS) part += a.tiecnt[s];
    block_scan(part, sh.red64, &base);
    if (base >= need) return;  // every tie to take lies in earlier runs
  }
  const int k = a.k;
  const int a_used = multi_table_width<OFFSETS, WT>(a.table_width, a.w);
  __syncthreads();  // the previous run's readers of the table and histogram are done
  const float* row_tab = a.tables + static_cast<size_t>(table_row(a, u)) * a.table_width;
  const float* table = a.gtab ? row_tab : s_table;
  if (!a.gtab) {
    for (int e = tid; e < a_used; e += THREADS) s_table[e] = __ldg(row_tab + e);
  }
  if (phase < PH_COMPACT2) {
    for (int i = tid; i < SEL_BINS; i += THREADS) sh.hist[i] = 0u;
  }
  if (tid == 0) *sh.count = 0;
  __syncthreads();
  float* ov = a.out_v + static_cast<size_t>(out_row) * k;
  int* oi = a.out_i + static_cast<size_t>(out_row) * k;

  if (phase < PH_COMPACT2) {
    const int sh_d = digit_shift(phase);
    const int sh_hi = phase == 0 ? 0 : digit_shift(phase - 1);
    const unsigned mask = phase == 2 ? 0x3ffu : 0x7ffu;
    unit_scan<CodeT, OFFSETS, WT, SORT>(a, table, u, ta, tz, sh.red,
                                        [&](int, const unsigned (&key)[R]) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const bool hit = key[j] != SEL_EXCL && (phase == 0 || (key[j] >> sh_hi) == (kstar >> sh_hi));
        hist_add(sh.hist, hit, (key[j] >> sh_d) & mask);
      }
    });
    __syncthreads();
    if (first == last) {  // the unit's one run: resolve here
      resolve(a, u, phase, sh.hist, false, sh);
      return;
    }
    unsigned* gh = a.hist + static_cast<size_t>(first) * SEL_BINS;
    for (int i = tid; i < SEL_BINS; i += THREADS) {
      const unsigned c = sh.hist[i];
      if (c) atomicAdd(gh + i, c);
    }
    if (last_to_arrive(st + ST_TICKET, static_cast<int>(last - first + 1), sh.last))
      resolve(a, u, phase, gh, true, sh);
    return;
  }

  // one lane per pick of the warp takes a slot from the counter at `ctr`
  auto slots = [&](bool pick, int* ctr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, pick);
    int pos = 0;
    if (lane == 0 && ballot) pos = atomicAdd(ctr, __popc(ballot));
    return __shfl_sync(0xffffffffu, pos, 0) + __popc(ballot & ((1u << lane) - 1u));
  };

  if (phase == PH_COMPACT) {
    const unsigned hi22 = kstar >> 10;
    unsigned long long* bk = a.bucket + st[ST_BOFF];
    unit_scan<CodeT, OFFSETS, WT, SORT>(a, table, u, ta, tz, sh.red,
                                        [&](int lo, const unsigned (&key)[R]) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const unsigned kk = key[j];
        const int row = lo + j * THREADS + tid;
        const bool take = mode == M_ALL ? kk != SEL_EXCL : (kk >> 10) < hi22;
        const int pos = slots(take, st + ST_WRITTEN);
        if (take) {
          ov[pos] = key_value(kk);
          oi[pos] = row;
        }
        const bool in_bucket = mode == M_BUCKET && kk != SEL_EXCL && (kk >> 10) == hi22;
        const int at = slots(in_bucket, st + ST_BUCKET);
        if (in_bucket)
          bk[at] = (static_cast<unsigned long long>(kk) << 32) | static_cast<unsigned>(row);
      }
    });
    return;
  }

  if (phase == PH_COMPACT2) {
    const bool take_ties = need == ties;
    unit_scan<CodeT, OFFSETS, WT, SORT>(a, table, u, ta, tz, sh.red,
                                        [&](int lo, const unsigned (&key)[R]) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const unsigned kk = key[j];
        const bool take = kk < kstar || (take_ties && kk == kstar);
        const int pos = slots(take, st + ST_WRITTEN);
        if (take) {
          ov[pos] = key_value(kk);
          oi[pos] = lo + j * THREADS + tid;
        }
        if (partial) {
          const unsigned tb = __ballot_sync(0xffffffffu, kk == kstar);
          if (lane == 0 && tb) atomicAdd(sh.count, __popc(tb));
        }
      }
    });
    __syncthreads();
    if (partial && tid == 0) a.tiecnt[slot] = *sh.count;
    return;
  }

  // PH_TIES: number this run's ties in row order after the earlier runs'
  unit_scan<CodeT, OFFSETS, WT, SORT>(a, table, u, ta, tz, sh.red,
                                      [&](int lo, const unsigned (&key)[R]) {
    unsigned tb[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      tb[j] = __ballot_sync(0xffffffffu, key[j] == kstar);
      if (lane == 0) sh.rank[j * (THREADS / 32) + warp] = __popc(tb[j]);
    }
    __syncthreads();
    long long at = base;  // ties before row lo + j * THREADS + tid
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int before = 0, all = 0;
#pragma unroll
      for (int w2 = 0; w2 < THREADS / 32; ++w2) {
        const int c = sh.rank[j * (THREADS / 32) + w2];
        before += w2 < warp ? c : 0;
        all += c;
      }
      const long long rank = at + before + __popc(tb[j] & ((1u << lane) - 1u));
      if (key[j] == kstar && rank < need) {
        ov[less + rank] = key_value(kstar);
        oi[less + rank] = lo + j * THREADS + tid;
      }
      at += all;
    }
    base = at;
    __syncthreads();  // the counts are read before the next pass writes them
  });
}

// The unit's output row (B6: grouped units' q0, else the unit; B7: the
// window; B2 / B5: the pair).
__device__ __forceinline__ int out_row(const SelectArgs& a, int u) {
  return a.n_valid != nullptr ? u : (a.units != nullptr ? __ldg(a.units + 4 * u + 2) : u);
}
__device__ __forceinline__ int out_row(const ScanSelectArgs& a, int u) { return __ldg(a.order + u); }

// The block's whole work in one phase: tiles [b * T / nb, (b + 1) * T / nb)
// and the runs of the units they cover (so slot b + u and the unit's first
// / last blocks are the same in every phase).
template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
__device__ void select_pass(const Args& a) {
  constexpr int R = multi_rows<CodeT, WT>();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long s_red64[THREADS / 32];
  __shared__ float s_red[THREADS / 32];
  __shared__ int s_rank[R * (THREADS / 32)];
  __shared__ int s_count, s_last;
  const int a_used = multi_table_width<OFFSETS, WT>(a.table_width, a.w);
  float* s_table = reinterpret_cast<float*>(smem);
  const SelShared sh{reinterpret_cast<unsigned*>(smem) + (a.gtab ? 0 : a_used), s_red64, s_red,
                     s_rank, &s_count, &s_last};
  const long long T = a.ustart[a.n_units];
  const long long nb = min(static_cast<long long>(gridDim.x), T);
  const long long b = blockIdx.x;
  if (b >= nb) return;
  const long long tb = b * T / nb, te = (b + 1) * T / nb;
  int lo = 0, hi = a.n_units;  // the unit of tile tb: the last u with ustart[u] <= tb
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (a.ustart[mid] <= tb) lo = mid; else hi = mid;
  }
  for (int u = lo; u < a.n_units; ++u) {
    const long long start = a.ustart[u];
    if (start >= te) break;
    const long long count = a.ustart[u + 1] - start;
    if (count == 0) continue;
    const long long ta = max(tb, start) - start, tz = min(te, start + count) - start;
    const long long first = ((start + 1) * nb - 1) / T;
    const long long last = ((start + count) * nb - 1) / T;
    select_run<CodeT, OFFSETS, WT, SORT>(a, s_table, sh, u, ta, tz, first, last, out_row(a, u));
  }
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())
adc_topk_select_kernel(const SelectArgs a) {
  select_pass<CodeT, OFFSETS, WT, SORT>(a);
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT>
__global__ void __launch_bounds__(THREADS, multi_min_blocks<1>())
adc_topk_scan_select_kernel(const ScanSelectArgs a) {
  select_pass<CodeT, OFFSETS, WT, SORT>(a);
}

// 64-bit sort key of an output entry: (the distance's order bits, row).
__device__ __forceinline__ unsigned long long entry_key(float v, int r) {
  return (static_cast<unsigned long long>(order_bits(v)) << 32) | static_cast<unsigned>(r);
}

// Compare-exchange of one step of the bitonic network in its every-step-
// ascending form (a merge's first step pairs i with the mirror of i in its
// block of `size`, the others i with i + stride): the n2 - n keys past n
// are the largest and never move, so they are never stored.
__device__ __forceinline__ void sort_pair(int i, int size, int stride, int& lo, int& hi) {
  const int off = i & (stride - 1);
  lo = ((i - off) << 1) + off;
  hi = stride == size / 2 ? lo - 2 * off + size - 1 : lo + stride;
}

__device__ __forceinline__ void order2(unsigned long long& a, unsigned long long& b) {
  const unsigned long long lo = a < b ? a : b, hi = a < b ? b : a;
  a = lo;
  b = hi;
}

// Steps of sizes [size0, size1] (each from stride size / 2, or from
// `stride0` in the first size) down to stride 1 on the n2 keys of `keys`
// (shared memory; those past n are the largest and are never stored).
// Every thread of the block (n2 / E of them) holds E consecutive keys in
// registers: a step whose stride is under E runs inside the thread, one
// under 32 E between the lanes of a warp by shuffles (a pair's partner sits
// in lane ^ stride / E, or, in a merge's first step, in the mirrored slot
// of lane ^ (size / E - 1)), and only the longer strides go through shared
// memory, with a barrier each.
template <int E>
__device__ void sort_steps(unsigned long long* keys, int n, int n2, int size0, int size1,
                           int stride0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  unsigned long long x[E];
  auto load = [&]() {
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = tid * E + j < n ? keys[tid * E + j] : ~0ull;
  };
  auto store = [&]() {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if (tid * E + j < n) keys[tid * E + j] = x[j];
  };
  load();
  if (size0 <= E) {  // a whole sort: every size up to E inside the thread
#pragma unroll
    for (int s = 2; s <= E; s <<= 1) {
#pragma unroll
      for (int st = s / 2; st > 0; st >>= 1) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int p = st == s / 2 ? j ^ (s - 1) : j ^ st;
          if (j < p) order2(x[j], x[p]);
        }
      }
    }
    size0 = 2 * E;
    stride0 = E;
  }
  for (int size = size0; size <= size1; size <<= 1) {
    int stride = size == size0 ? stride0 : size / 2;
    if (stride >= 32 * E) {
      store();
      __syncthreads();
      for (; stride >= 32 * E; stride >>= 1) {
        for (int i = tid; i < n2 / 2; i += blockDim.x) {
          int lo, hi;
          sort_pair(i, size, stride, lo, hi);
          if (hi < n) order2(keys[lo], keys[hi]);
        }
        __syncthreads();
      }
      load();
    }
    for (; stride >= E; stride >>= 1) {
      if (stride == size / 2) {  // the merge's first step: mirrored partners
        const int m = size / E - 1;
        const bool lower = (lane & (size / (2 * E))) == 0;
#pragma unroll
        for (int j = 0; j < E / 2; ++j) {
          const unsigned long long a = __shfl_xor_sync(0xffffffffu, x[E - 1 - j], m);
          const unsigned long long b = __shfl_xor_sync(0xffffffffu, x[j], m);
          x[j] = lower == (a < x[j]) ? a : x[j];
          x[E - 1 - j] = lower == (b < x[E - 1 - j]) ? b : x[E - 1 - j];
        }
      } else {
        const int m = stride / E;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const unsigned long long y = __shfl_xor_sync(0xffffffffu, x[j], m);
          x[j] = lower == (y < x[j]) ? y : x[j];
        }
      }
    }
#pragma unroll
    for (int st = E / 2; st > 0; st >>= 1) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (j < (j ^ st)) order2(x[j], x[j ^ st]);
      }
    }
  }
  store();
  __syncthreads();
}




struct SortArgs {
  const int* state;
  const int* units;
  const int* n_valid;
  const unsigned long long* bucket;
  float* out_v;
  int* out_i;
  int n_q, k;
};

// B2 / B5's last two steps also read each pair's tiles, bound and counters.
struct ScanSortArgs : SortArgs {
  const long long* ustart;
  const int* order;
  const int* pair_t0;     // B2, or null
  const int* tile_row0;
  const int* pair_nv;
  const int* pair_q;
  const float* bound;
  const float* sq;
  int* stats;
  int block_n;
};

template <typename SArgs>
constexpr bool kScanSort = std::is_same<SArgs, ScanSortArgs>::value;

// The output row of unit u: B7's pair u, grouped B6's unit table, or B6's
// table u; B2 / B5's pair.
__device__ __forceinline__ int unit_row(const SortArgs& a, int u) {
  return a.n_valid != nullptr ? u : (a.units != nullptr ? __ldg(a.units + 4 * u + 2) : u);
}
__device__ __forceinline__ int unit_row(const ScanSortArgs& a, int u) { return __ldg(a.order + u); }

// Keys of a bucket ranked by counting (each against all, O(n^2 / threads))
// rather than sorted: the bucket's usual few hundred rows need no network.
constexpr int BUCKET_COUNT_MAX = 1024;

// The bucket pass: one block per unit with its bucket buffered puts the
// k - c smallest of the bucket's (key, row) pairs, in order, at c onwards:
// by each key's rank among them, or past BUCKET_COUNT_MAX by sorting.  A
// B2 / B5 pair its compaction skipped has nothing to place.
template <typename SArgs>
__global__ void __launch_bounds__(SORT_THREADS) adc_topk_select_bucket_kernel(const SArgs a) {
  extern __shared__ __align__(16) unsigned long long keys[];
  const int u = blockIdx.x;
  const int* st = a.state + static_cast<size_t>(u) * SEL_STATE;
  if (st[ST_MODE] != M_BUCKET || st[ST_DROP]) return;
  const int n = st[ST_BUCKET], need = st[ST_NEED], less = st[ST_LESS];
  const unsigned long long* bk = a.bucket + st[ST_BOFF];
  for (int i = threadIdx.x; i < n; i += SORT_THREADS) keys[i] = bk[i];
  __syncthreads();
  const size_t row = static_cast<size_t>(unit_row(a, u)) * a.k + less;
  auto put = [&](int at, unsigned long long key) {
    a.out_v[row + at] = key_value(static_cast<unsigned>(key >> 32));
    a.out_i[row + at] = static_cast<int>(key & 0xffffffffu);
  };
  if (n <= BUCKET_COUNT_MAX) {
    for (int i = threadIdx.x; i < n; i += SORT_THREADS) {
      const unsigned long long key = keys[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += keys[j] < key;  // keys are distinct: rows differ
      if (rank < need) put(rank, key);
    }
    return;
  }
  sort_steps<SEL_BUCKET / SORT_THREADS>(keys, n, SEL_BUCKET, 2, SEL_BUCKET, 1);
  for (int i = threadIdx.x; i < need; i += SORT_THREADS) put(i, keys[i]);
}

// A B2 / B5 pair its compaction skipped: every entry (+inf, -1), and its
// tiles with rows and those rows counted as skipped (the shared block's
// counters).
__device__ void skipped_pair(const ScanSortArgs& a, int u, int pair) {
  __shared__ int s_tiles, s_rows;
  const int tid = threadIdx.x;
  const int k = a.k;
  for (int i = tid; i < k; i += SORT_THREADS) {
    a.out_v[static_cast<size_t>(pair) * k + i] = CUDART_INF_F;
    a.out_i[static_cast<size_t>(pair) * k + i] = -1;
  }
  if (tid == 0) s_tiles = s_rows = 0;
  __syncthreads();
  const int nt = static_cast<int>(a.ustart[u + 1] - a.ustart[u]);
  const int nv = __ldg(a.pair_nv + pair);
  int tiles = 0, rows = 0;
  for (int t = tid; t < nt; t += SORT_THREADS) {
    const int row0 = a.pair_t0 != nullptr ? __ldg(a.tile_row0 + __ldg(a.pair_t0 + pair) + t)
                                          : t * a.block_n;
    const int r = min(max(nv - row0, 0), a.block_n);
    tiles += r > 0;
    rows += r;
  }
  if (tiles) atomicAdd(&s_tiles, tiles);
  if (rows) atomicAdd(&s_rows, rows);
  __syncthreads();
  if (tid == 0) {
    a.stats[2 * static_cast<size_t>(pair)] = s_tiles;
    a.stats[2 * static_cast<size_t>(pair) + 1] = s_rows;
  }
}

template <typename SArgs>
__device__ void sort_long(const SArgs& a, unsigned long long* keys, float* ov, int* oi,
                          int n_out, int n2);

// The last pass: one block per unit sorts its output row's first n_out
// entries by (distance, row) and pads the rest with (+inf, -1); E keys a
// thread: 8 for k <= 8192, else 16 (chunks of SORT_CHUNK past that).  B2 /
// B5: a pair without tiles is left as it is, a skipped pair is
// `skipped_pair`, and any other drops its winners above min(bound[q],
// sq[q]) (a suffix of the sorted row) and counts nothing skipped.
template <int E, typename SArgs>
__global__ void __launch_bounds__(SORT_THREADS) adc_topk_select_sort_kernel(const SArgs a) {
  extern __shared__ __align__(16) unsigned long long keys[];
  const int u = blockIdx.x;
  const int tid = threadIdx.x;
  const int* st = a.state + static_cast<size_t>(u) * SEL_STATE;
  const int q0 = unit_row(a, u);
  const int k = a.k;
  float cut = CUDART_INF_F;
  if constexpr (kScanSort<SArgs>) {
    if (a.ustart[u + 1] == a.ustart[u]) return;
    if (st[ST_DROP]) {
      skipped_pair(a, u, q0);
      return;
    }
    const int qi = __ldg(a.pair_q + q0);
    cut = fminf(__ldg(a.bound + qi), __ldcg(a.sq + qi));
    if (tid == 0) {
      a.stats[2 * static_cast<size_t>(q0)] = 0;
      a.stats[2 * static_cast<size_t>(q0) + 1] = 0;
    }
  }
  const int n_out = st[ST_NOUT];
  float* ov = a.out_v + static_cast<size_t>(q0) * k;
  int* oi = a.out_i + static_cast<size_t>(q0) * k;
  int n2 = 8 * SORT_THREADS;  // k > 4096: n2 >= 8192 keys, 8 or more a thread
  while (n2 < k) n2 <<= 1;
  if (n2 <= SORT_CHUNK) {
    for (int i = tid; i < k; i += SORT_THREADS)
      keys[i] = i < n_out ? entry_key(ov[i], oi[i]) : ~0ull;
    __syncthreads();
    sort_steps<E>(keys, n_out, n2, 2, n2, 1);
    for (int i = tid; i < k; i += SORT_THREADS) {
      const float v = key_value(static_cast<unsigned>(keys[i] >> 32));
      const bool real = i < n_out && v <= cut;
      ov[i] = real ? v : CUDART_INF_F;
      oi[i] = real ? static_cast<int>(keys[i] & 0xffffffffu) : -1;
    }
    return;
  }
  if constexpr (E == SORT_CHUNK / SORT_THREADS) {
    sort_long(a, keys, ov, oi, n_out, n2);
    if constexpr (kScanSort<SArgs>) {
      for (int i = tid; i < k; i += SORT_THREADS) {
        if (!(ov[i] <= cut)) {
          ov[i] = CUDART_INF_F;
          oi[i] = -1;
        }
      }
    }
  }
}

// The sort of a k past a block's shared memory (from the sort kernel with
// SORT_CHUNK keys a block): chunks of SORT_CHUNK sorted in shared memory,
// the longer strides on the output row in device memory.
template <typename SArgs>
__device__ void sort_long(const SArgs& a, unsigned long long* keys, float* ov, int* oi,
                          int n_out, int n2) {
  constexpr int E = SORT_CHUNK / SORT_THREADS;
  const int tid = threadIdx.x;
  const int k = a.k;
  for (int i = n_out + tid; i < k; i += SORT_THREADS) {
    ov[i] = CUDART_INF_F;
    oi[i] = -1;
  }
  __syncthreads();
  auto chunk_pass = [&](int size0, int size1, int stride0) {
    for (int c0 = 0; c0 < k; c0 += SORT_CHUNK) {
      const int n = min(SORT_CHUNK, k - c0);
      for (int i = tid; i < n; i += SORT_THREADS)
        keys[i] = entry_key(__ldcg(ov + c0 + i), __ldcg(oi + c0 + i));
      __syncthreads();
      sort_steps<E>(keys, n, SORT_CHUNK, size0, size1, stride0);
      for (int i = tid; i < n; i += SORT_THREADS) {
        ov[c0 + i] = key_value(static_cast<unsigned>(keys[i] >> 32));
        oi[c0 + i] = static_cast<int>(keys[i] & 0xffffffffu);
      }
      __syncthreads();
    }
  };
  chunk_pass(2, SORT_CHUNK, 1);
  for (int size = 2 * SORT_CHUNK; size <= n2; size <<= 1) {
    for (int stride = size / 2; stride >= SORT_CHUNK; stride >>= 1) {
      for (int i = tid; i < n2 / 2; i += SORT_THREADS) {
        int lo, hi;
        sort_pair(i, size, stride, lo, hi);
        if (hi < k) {
          const unsigned long long p = entry_key(__ldcg(ov + lo), __ldcg(oi + lo));
          const unsigned long long q = entry_key(__ldcg(ov + hi), __ldcg(oi + hi));
          if (q < p) {
            ov[lo] = key_value(static_cast<unsigned>(q >> 32));
            oi[lo] = static_cast<int>(q & 0xffffffffu);
            ov[hi] = key_value(static_cast<unsigned>(p >> 32));
            oi[hi] = static_cast<int>(p & 0xffffffffu);
          }
        }
      }
      __threadfence_block();
      __syncthreads();
    }
    chunk_pass(size, size, SORT_CHUNK / 2);  // the merge's strides inside a chunk
  }
}

inline size_t select_smem_bytes(int a_used, int gtab) {
  return (static_cast<size_t>(gtab ? 0 : a_used) + SEL_BINS) * 4;
}

inline size_t sort_smem_bytes(int k) {
  int n2 = 8 * SORT_THREADS;
  while (n2 < k && n2 < SORT_CHUNK) n2 <<= 1;
  return static_cast<size_t>(n2) * 8;
}

// The scoring kernel of an instantiation for B6 / B7's or B2 / B5's units.
template <typename CodeT, bool OFFSETS, int WT, bool SORT>
auto kernel_of(const SelectArgs*) { return adc_topk_select_kernel<CodeT, OFFSETS, WT, SORT>; }
template <typename CodeT, bool OFFSETS, int WT, bool SORT>
auto kernel_of(const ScanSelectArgs*) {
  return adc_topk_scan_select_kernel<CodeT, OFFSETS, WT, SORT>;
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
int launch_phase(const Args& a, int n_blocks, cudaStream_t stream) {
  auto kernel = kernel_of<CodeT, OFFSETS, WT, SORT>(&a);
  const size_t smem = select_smem_bytes(multi_table_width<OFFSETS, WT>(a.table_width, a.w), a.gtab);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT, bool OFFSETS, int WT, bool SORT, typename Args>
int blocks_per_sm(int table_width, int w, int gtab) {
  auto kernel = kernel_of<CodeT, OFFSETS, WT, SORT>(static_cast<const Args*>(nullptr));
  const size_t smem = select_smem_bytes(multi_table_width<OFFSETS, WT>(table_width, w), gtab);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, smem);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <typename Args>
int dispatch_phase(const Args& a, int code_fmt, int w, int onehot, int n_blocks,
                   cudaStream_t st) {
#define REPRO_SELECT_LAUNCH(CodeT, OFF, WT, SORT) launch_phase<CodeT, OFF, WT, SORT>(a, n_blocks, st)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_SELECT_LAUNCH)
#undef REPRO_SELECT_LAUNCH
}

template <typename Args>
int dispatch_blocks_per_sm(int code_fmt, int onehot, int w, int table_width, int gtab) {
#define REPRO_SELECT_OCC(CodeT, OFF, WT, SORT) \
  blocks_per_sm<CodeT, OFF, WT, SORT, Args>(table_width, w, gtab)
  REPRO_ADC_DISPATCH_WIDE(code_fmt, w, onehot, REPRO_SELECT_OCC)
#undef REPRO_SELECT_OCC
}

// Each step of one select call (a memset, then kernels), in launch order:
// the length of the `split_ms` array the launchers fill.
constexpr int SEL_STEPS = 10;

// The scratch of one call (kernels/adc_topk.py `select_scratch`, int32
// entries): the units' states, the blocks' histograms and the pool counter
// (zeroed by the call's memset: `zero_bytes`), a tie count a run, each
// unit's first tile, B2 / B5's bounds at the start (n_q), the bucket pool.
struct Scratch {
  int* state;
  unsigned* hist;
  int* pool_used;
  int* tiecnt;
  long long* ustart;
  float* sq0;
  unsigned long long* bucket;
  long long pool_cap;
  size_t zero_bytes;
};

Scratch carve(void* scratch, int n_units, int n_blocks, int n_q) {
  int* p = static_cast<int*>(scratch);
  Scratch s;
  size_t at = 0;
  s.state = p;
  at += static_cast<size_t>(n_units) * SEL_STATE;
  s.hist = reinterpret_cast<unsigned*>(p + at);
  at += static_cast<size_t>(n_blocks) * SEL_BINS;
  s.pool_used = p + at;
  at += 2;
  s.zero_bytes = at * sizeof(int);
  s.tiecnt = p + at;
  at += static_cast<size_t>(n_blocks) + n_units;
  at += at & 1;
  s.ustart = reinterpret_cast<long long*>(p + at);
  at += 2 * (static_cast<size_t>(n_units) + 1);
  s.sq0 = reinterpret_cast<float*>(p + at);
  at += static_cast<size_t>(n_q) + (n_q & 1);
  s.bucket = reinterpret_cast<unsigned long long*>(p + at);
  s.pool_cap = static_cast<long long>(n_units) * SEL_POOL_PER_UNIT + SEL_BUCKET;
  return s;
}

// The chain of one call on `st`: a memset of the zeroed scratch, the plan,
// the six scoring passes (hist0, hist1, compact, hist2, compact2, ties),
// the bucket pass and the sort.  `launched` (host int, or null) gains one
// for each step enqueued.  `split_ms` (host, SEL_STEPS floats, or null):
// when given, CUDA events are recorded on the stream around every step,
// the call waits for the last, and entry i is step i's time on the card,
// from the end of the step before it.  Returns the first non-zero
// cudaError_t, or 0.
template <typename Args, typename SArgs>
int run_chain(Args& a, const SArgs& s, const Scratch& sc, int code_fmt, int w, int onehot,
              int n_blocks, int* launched, float* split_ms, cudaStream_t st) {
  cudaEvent_t ev[SEL_STEPS + 1] = {};
  const int n_ev = split_ms != nullptr ? SEL_STEPS + 1 : 0;
  int step = 0;
  cudaError_t e = cudaSuccess;
  for (int i = 0; i < n_ev && e == cudaSuccess; ++i) e = cudaEventCreate(&ev[i]);
  // after each enqueued step: count it, and stamp its end when timing
  auto done = [&](cudaError_t err) {
    if (err != cudaSuccess) return err;
    ++step;
    if (launched != nullptr) ++*launched;
    return n_ev ? cudaEventRecord(ev[step], st) : cudaSuccess;
  };
  auto run = [&]() -> cudaError_t {
    cudaError_t err = n_ev ? cudaEventRecord(ev[0], st) : cudaSuccess;
    if (err != cudaSuccess) return err;
    if ((err = done(cudaMemsetAsync(sc.state, 0, sc.zero_bytes, st))) != cudaSuccess) return err;
    adc_topk_select_plan_kernel<Args><<<1, THREADS, 0, st>>>(a);
    if ((err = done(cudaGetLastError())) != cudaSuccess) return err;
    for (const int phase : {0, 1, static_cast<int>(PH_COMPACT), 2,
                            static_cast<int>(PH_COMPACT2), static_cast<int>(PH_TIES)}) {
      a.phase = phase;
      err = done(static_cast<cudaError_t>(dispatch_phase(a, code_fmt, w, onehot, n_blocks, st)));
      if (err != cudaSuccess) return err;
    }
    const size_t bucket_smem = static_cast<size_t>(SEL_BUCKET) * 8;
    err = set_smem(adc_topk_select_bucket_kernel<SArgs>, bucket_smem);
    if (err != cudaSuccess) return err;
    adc_topk_select_bucket_kernel<SArgs><<<a.n_units, SORT_THREADS, bucket_smem, st>>>(s);
    if ((err = done(cudaGetLastError())) != cudaSuccess) return err;
    const size_t smem = sort_smem_bytes(a.k);
    auto sort = a.k <= 8 * SORT_THREADS ? adc_topk_select_sort_kernel<8, SArgs>
                                        : adc_topk_select_sort_kernel<16, SArgs>;
    if ((err = set_smem(sort, smem)) != cudaSuccess) return err;
    sort<<<a.n_units, SORT_THREADS, smem, st>>>(s);
    return done(cudaGetLastError());
  };
  if (e == cudaSuccess) e = run();
  if (e == cudaSuccess && n_ev) e = cudaEventSynchronize(ev[SEL_STEPS]);
  for (int i = 0; i < SEL_STEPS && e == cudaSuccess && n_ev; ++i)
    e = cudaEventElapsedTime(split_ms + i, ev[i], ev[i + 1]);
  for (int i = 0; i < n_ev; ++i)
    if (ev[i] != nullptr) cudaEventDestroy(ev[i]);
  return static_cast<int>(e);
}

}  // namespace

// One call of B6 / B7 under the select plan (`run_chain`).  B6: units
// (n_units, 4) int32 {row0, n_rows, q0, nq = 1} or null (n_q units over all
// n_rows rows), n_valid null.  B7: n_valid (n_units,) int32 and win_len rows
// a window, units null.  tables (n_q, table_width) f32; codes in `code_fmt`
// (0 uint8 raw + column offsets, 1 uint16, 2 int32 direct addresses); bound
// (n_q,) f32 or null; out_* (n_q, k), every row a unit covers rewritten;
// scratch (kernels/adc_topk.py `select_scratch` with n_q 0) int32 entries.
// `launched` and `split_ms` as `run_chain`.  Returns the first non-zero
// cudaError_t, or 0.
extern "C" int adc_topk_select_launch(const void* tables, const void* codes, const void* bound,
                                      const void* units, const void* n_valid, void* out_v,
                                      void* out_i, void* scratch, long long win_len, int n_units,
                                      int n_q, int n_rows, int w, int table_width, int code_fmt,
                                      int onehot, int k, int block_n, int gtab, int n_blocks,
                                      int* launched, float* split_ms, void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  const Scratch sc = carve(scratch, n_units, n_blocks, 0);
  SelectArgs a{{static_cast<const float*>(tables), codes, static_cast<const float*>(bound),
                static_cast<const int*>(units), static_cast<const int*>(n_valid),
                static_cast<float*>(out_v), static_cast<int*>(out_i), nullptr, nullptr,
                nullptr, win_len, n_units, n_q, n_rows, w, table_width, k, block_n},
               gtab, 0, sc.state, sc.hist, sc.tiecnt, sc.bucket, sc.pool_used, sc.pool_cap,
               sc.ustart};
  const SortArgs s{sc.state, static_cast<const int*>(units), static_cast<const int*>(n_valid),
                   sc.bucket, static_cast<float*>(out_v), static_cast<int*>(out_i), n_q, k};
  return run_chain(a, s, sc, code_fmt, w, onehot, n_blocks, launched, split_ms,
                   static_cast<cudaStream_t>(stream));
}

// One call of B2 (pair_t0 / pair_t1 / tile_block / tile_row0 given,
// starts null) or B5 (starts given, the tile arrays null) under the select
// plan (`run_chain`), over the n_units pairs of `order`, as
// adc_topk_tiles_launch / adc_topk_windows_launch take them: tables (R,
// table_width) f32, lut_row / n_valid / pair_q / pair_lb (P_all,), codes
// (ndev, cap, w), bound and sq (n_q,) f32 (sq tightened in place), out_*
// (P_all, k) and stats (P_all, 2): each unit's pair rewritten but for a
// pair without tiles.  scratch: `select_scratch(n_units, n_blocks, n_q)`
// int32 entries.  `launched` and `split_ms` as `run_chain`.
extern "C" int adc_topk_scan_select_launch(
    const void* tables, const void* lut_row, const void* codes, const void* order,
    const void* pair_t0, const void* pair_t1, const void* tile_block, const void* tile_row0,
    const void* starts, const void* n_valid, const void* pair_q, const void* pair_lb,
    const void* bound, void* sq, void* out_v, void* out_i, void* stats, void* scratch,
    int n_units, int n_q, int pairs_per_dev, long long cap, int w, int table_width,
    int code_fmt, int onehot, int k, int block_n, int gtab, int n_blocks, int* launched,
    float* split_ms, void* stream) {
  if (n_units <= 0 || n_blocks <= 0) return 0;
  const Scratch sc = carve(scratch, n_units, n_blocks, n_q);
  auto ci = [](const void* p) { return static_cast<const int*>(p); };
  ScanSelectArgs a{{{static_cast<const float*>(tables), codes, static_cast<const float*>(bound),
                     nullptr, nullptr, static_cast<float*>(out_v), static_cast<int*>(out_i),
                     nullptr, nullptr, nullptr, 0, n_units, n_q, 0, w, table_width, k, block_n},
                    gtab, 0, sc.state, sc.hist, sc.tiecnt, sc.bucket, sc.pool_used, sc.pool_cap,
                    sc.ustart},
                   ci(lut_row), ci(order), ci(pair_t0), ci(pair_t1), ci(tile_block),
                   ci(tile_row0), ci(starts), ci(n_valid), ci(pair_q),
                   static_cast<const float*>(pair_lb), static_cast<float*>(sq), sc.sq0,
                   static_cast<int*>(stats), cap, pairs_per_dev};
  ScanSortArgs s{{sc.state, nullptr, nullptr, sc.bucket, static_cast<float*>(out_v),
                  static_cast<int*>(out_i), n_q, k},
                 sc.ustart, ci(order), ci(pair_t0), ci(tile_row0), ci(n_valid), ci(pair_q),
                 static_cast<const float*>(bound), static_cast<const float*>(sq),
                 static_cast<int*>(stats), block_n};
  return run_chain(a, s, sc, code_fmt, w, onehot, n_blocks, launched, split_ms,
                   static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the scoring kernel a select call would run
// (`pairs` nonzero: B2 / B5's, else B6 / B7's), or minus a cudaError_t.
extern "C" int adc_topk_select_blocks_per_sm(int code_fmt, int onehot, int w, int table_width,
                                             int gtab, int pairs) {
  return pairs ? dispatch_blocks_per_sm<ScanSelectArgs>(code_fmt, onehot, w, table_width, gtab)
               : dispatch_blocks_per_sm<SelectArgs>(code_fmt, onehot, w, table_width, gtab);
}
