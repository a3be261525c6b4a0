// Kernel B2: fused ADC scan + running per-pair top-k over the tile queue,
// with the exact whole-tile pruning of early-pruning v2.
//
// Replaces: src/repro/kernels/adc_topk.py `adc_topk_tiles_kernel`
//           (Pallas bodies `_adc_topk_tiles_kernel`, `_merge_candidates`).
//
// The TPU kernel walks the flat tile queue as one sequential grid and keeps
// every pair's running top-k and every query's running bound `sq` in VMEM
// scratch across grid steps.  Blocks of a GPU grid run in parallel and in no
// order, so this kernel gives each pair RUN its own block: `emit_tiles`
// keeps a pair's tiles contiguous and in ascending rows, so the wrapper
// (kernels/adc_topk.py) computes each pair's tile range [t0, t1) and a
// launch order, and the block loops over the run's tiles.  Within a block:
//
//   * the pair's LUT (M x 256 f32, 16 KB at M = 16), row lut_row[pair] of
//     the tables, lives in shared memory (a pair without a table, -1, is
//     not scanned);
//   * each tile's rows stream from device memory, one 16-byte load per row
//     at M = 16 (raw uint8 codes; the column offset m * 256 is added here,
//     as `add_offsets` does), ROWS_PER_THREAD rows per thread in flight;
//   * the running top-k sits in shared memory, ascending by (distance, row)
//     and initialised to (+inf, -1); a pass keeps rows with d < k-th (a row
//     equal to the k-th has a larger row index and would lose the tie) and
//     d <= the query bound, bitonic-sorts them and merges them into the
//     top-k with a merge-path rank per element;
//   * `sq[q]`, the least k-th seen among query q's pairs, is shared by all
//     of the query's blocks through atomicMin on the float's bit pattern
//     (ADC distances are >= 0, so int order is float order).
//
// A tile is skipped only by the reference's rule, `lb >= pair k-th` or
// `lb > min(b0, sq)`, and a row is dropped only when it is above the query
// bound.  Either way the dropped rows lie strictly beyond the query's final
// k-th, so every pair's list agrees with the unpruned scan on all entries
// up to that k-th, and the merged per-query output is bit-identical to the
// unpruned scan in any execution order.  The per-pair tails past the k-th
// and the (P, 2) skip counters depend on the order and differ from the
// TPU's.  ADC sums add the M table entries in column order with no
// contraction, bit-equal to the plain version `adc_topk_tiles_plain`.
//
// What bounds it on an H100: bytes.  Every probed valid row is 16 bytes
// read once from device memory (3.35 TB/s); the 16 table lookups per row
// are shared-memory gathers of the same order.  Pruned tiles are never
// read.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int NCODES = 256;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = 4;
constexpr int PASS = THREADS * ROWS_PER_THREAD;  // rows scored per merge

__device__ __forceinline__ bool key_less(float av, int ar, float bv, int br) {
  return av < bv || (av == bv && ar < br);
}

template <int MT>
__device__ __forceinline__ float adc_row(const float* lut,
                                         const uint8_t* __restrict__ row,
                                         int m_rt) {
  if constexpr (MT > 0 && MT % 4 == 0) {
    uint32_t w[MT / 4];
    if constexpr (MT % 16 == 0) {
#pragma unroll
      for (int q = 0; q < MT / 16; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    } else if constexpr (MT % 8 == 0) {
#pragma unroll
      for (int q = 0; q < MT / 8; ++q) {
        const uint2 v = reinterpret_cast<const uint2*>(row)[q];
        w[2 * q] = v.x;
        w[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int q = 0; q < MT / 4; ++q)
        w[q] = reinterpret_cast<const uint32_t*>(row)[q];
    }
    float d = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
      d = __fadd_rn(d, lut[m * NCODES + ((w[m >> 2] >> ((m & 3) * 8)) & 0xffu)]);
    return d;
  } else {
    float d = 0.f;
    for (int m = 0; m < m_rt; ++m) d = __fadd_rn(d, lut[m * NCODES + row[m]]);
    return d;
  }
}

// Merge the c candidates in cand_* into the ascending top-k list top_*.
// Every thread of the block calls it; it ends with a barrier.
__device__ void merge_candidates(float* top_v, int* top_i, float* nxt_v,
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

template <int MT>
__global__ void __launch_bounds__(THREADS)
adc_topk_tiles_kernel(const float* __restrict__ luts,       // (R, M*256)
                      const int* __restrict__ lut_row,      // (P_all,)
                      const uint8_t* __restrict__ codes,    // (ndev, cap, M)
                      const int* __restrict__ pair_order,   // (P_all,)
                      const int* __restrict__ pair_t0,      // (P_all,)
                      const int* __restrict__ pair_t1,      // (P_all,)
                      const int* __restrict__ tile_block,   // (ndev*T,)
                      const int* __restrict__ tile_row0,    // (ndev*T,)
                      const int* __restrict__ n_valid,      // (P_all,)
                      const int* __restrict__ pair_q,       // (P_all,)
                      const float* __restrict__ pair_lb,    // (P_all,)
                      const float* __restrict__ bound,      // (Q,)
                      float* sq,                            // (Q,) shared
                      float* __restrict__ out_v,            // (P_all, k)
                      int* __restrict__ out_i,              // (P_all, k)
                      int* __restrict__ stats,              // (P_all, 2)
                      int pairs_per_dev, long long cap, int m_rt, int k,
                      int block_n) {
  const int M = MT > 0 ? MT : m_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);
  float* top_v = lut + M * NCODES;
  int* top_i = reinterpret_cast<int*>(top_v + k);
  float* nxt_v = reinterpret_cast<float*>(top_i + k);
  int* nxt_i = reinterpret_cast<int*>(nxt_v + k);
  float* cand_v = reinterpret_cast<float*>(nxt_i + k);
  int* cand_i = reinterpret_cast<int*>(cand_v + PASS);
  __shared__ int s_ncand;
  __shared__ int s_skip;
  __shared__ float s_qb;

  const int pair = pair_order[blockIdx.x];
  const int t0 = pair_t0[pair];
  const int t1 = pair_t1[pair];
  const int row = lut_row[pair];
  if (t0 >= t1 || row < 0) return;  // no tiles, or no table
  const int tid = threadIdx.x;

  const float* lp = luts + static_cast<size_t>(row) * M * NCODES;
  for (int i = tid; i < M * NCODES; i += THREADS) lut[i] = lp[i];
  for (int i = tid; i < k; i += THREADS) {
    top_v[i] = CUDART_INF_F;
    top_i[i] = -1;
  }
  const int qi = pair_q[pair];
  const float lb = pair_lb[pair];
  const float b0 = bound[qi];
  const int nv = n_valid[pair];
  const uint8_t* cdev =
      codes + static_cast<size_t>(pair / pairs_per_dev) * cap * M;
  int n_skip = 0, n_avoid = 0;
  __syncthreads();

  for (int t = t0; t < t1; ++t) {
    const int row0 = tile_row0[t];
    const int blk = tile_block[t];
    if (tid == 0) {
      const float qb = fminf(b0, __ldcg(sq + qi));
      const float kth = top_v[k - 1];
      const int skip = (lb >= kth) || (lb > qb);
      if (skip) {
        const int rows = min(max(nv - row0, 0), block_n);
        n_skip += rows > 0;
        n_avoid += rows;
      }
      s_skip = skip;
      s_qb = qb;
    }
    __syncthreads();
    if (!s_skip) {
      const float qb = s_qb;
      const int n_rows = min(block_n, nv - row0);
      const uint8_t* tile = cdev + static_cast<size_t>(blk) * block_n * M;
      for (int base = 0; base < n_rows; base += PASS) {
        const float kth = top_v[k - 1];
        float d[ROWS_PER_THREAD];
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j) {
          const int i = base + j * THREADS + tid;
          d[j] = i < n_rows
                     ? adc_row<MT>(lut, tile + static_cast<size_t>(i) * M, M)
                     : CUDART_INF_F;
        }
        if (tid == 0) s_ncand = 0;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ROWS_PER_THREAD; ++j) {
          const int i = base + j * THREADS + tid;
          if (i < n_rows && d[j] < kth && d[j] <= qb) {
            const int s = atomicAdd(&s_ncand, 1);
            cand_v[s] = d[j];
            cand_i[s] = row0 + i;
          }
        }
        __syncthreads();
        const int c = s_ncand;
        if (c > 0)
          merge_candidates(top_v, top_i, nxt_v, nxt_i, cand_v, cand_i, c, k);
      }
    }
    if (tid == 0) {
      const float kth = top_v[k - 1];
      if (kth < CUDART_INF_F)
        atomicMin(reinterpret_cast<int*>(sq + qi), __float_as_int(kth));
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += THREADS) {
    out_v[static_cast<size_t>(pair) * k + i] = top_v[i];
    out_i[static_cast<size_t>(pair) * k + i] = top_i[i];
  }
  if (tid == 0) {
    stats[2 * static_cast<size_t>(pair)] = n_skip;
    stats[2 * static_cast<size_t>(pair) + 1] = n_avoid;
  }
}

template <int MT>
int launch(const float* luts, const int* lut_row, const uint8_t* codes,
           const int* order, const int* t0, const int* t1, const int* tile_block,
           const int* tile_row0, const int* n_valid, const int* pair_q,
           const float* pair_lb, const float* bound, float* sq, float* out_v,
           int* out_i, int* stats, int n_pairs, int pairs_per_dev,
           long long cap, int m, int k, int block_n, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(m) * NCODES + 4 * k + 2 * PASS) * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        adc_topk_tiles_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  adc_topk_tiles_kernel<MT><<<n_pairs, THREADS, smem, stream>>>(
      luts, lut_row, codes, order, t0, t1, tile_block, tile_row0, n_valid,
      pair_q, pair_lb, bound, sq, out_v, out_i, stats, pairs_per_dev, cap, m,
      k, block_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int adc_topk_tiles_launch(
    const void* luts, const void* lut_row, const void* codes,
    const void* pair_order, const void* pair_t0, const void* pair_t1,
    const void* tile_block,
    const void* tile_row0, const void* n_valid, const void* pair_q,
    const void* pair_lb, const void* bound, void* sq, void* out_v,
    void* out_i, void* stats, int n_pairs, int pairs_per_dev, long long cap,
    int m, int k, int block_n, void* stream) {
  if (n_pairs <= 0) return 0;
#define REPRO_ADC_ARGS                                                       \
  static_cast<const float*>(luts), static_cast<const int*>(lut_row),        \
      static_cast<const uint8_t*>(codes),                                   \
      static_cast<const int*>(pair_order), static_cast<const int*>(pair_t0), \
      static_cast<const int*>(pair_t1), static_cast<const int*>(tile_block), \
      static_cast<const int*>(tile_row0), static_cast<const int*>(n_valid),  \
      static_cast<const int*>(pair_q), static_cast<const float*>(pair_lb),   \
      static_cast<const float*>(bound), static_cast<float*>(sq),            \
      static_cast<float*>(out_v), static_cast<int*>(out_i),                 \
      static_cast<int*>(stats), n_pairs, pairs_per_dev, cap, m, k, block_n, \
      static_cast<cudaStream_t>(stream)
  switch (m) {
    case 8: return launch<8>(REPRO_ADC_ARGS);
    case 16: return launch<16>(REPRO_ADC_ARGS);
    case 32: return launch<32>(REPRO_ADC_ARGS);
    default: return launch<0>(REPRO_ADC_ARGS);
  }
#undef REPRO_ADC_ARGS
}
