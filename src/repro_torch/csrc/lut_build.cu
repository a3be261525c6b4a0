// Kernel B1: per-pair ADC lookup tables, LUT[p, m, j] = ||r_{p,m} - cb[m, j]||^2.
//
// Replaces: src/repro/kernels/lut_build.py `lut_build_kernel`
//           (Pallas body `_lut_build_kernel`, one grid step per (pair, m)).
//
// What bounds it on an H100: the table write.  A pair's table is
// M x 256 f32 = 16 KB at SIFT geometry (M = 16, dsub = 8), 1.05 GB for the
// 64k pairs of a 1000-query batch at nprobe 64 (0.31 ms at 3.35 TB/s).
// Each 4-byte entry costs 3 * dsub = 24 f32 operations, 6 per byte, below
// the card's 20 FP32 operations per byte of memory rate.  The expansion
// ||r||^2 - 2 r.c + ||c||^2 would save arithmetic that is not the limit,
// and it cancels: the pruning margins of the host planner
// (_BOUND_REL = 1e-4, _BOUND_ABS = 1e-6) are sized for the rounding of a
// direct sum.  So the direct form stays, with no TF32 and no FMA
// contraction (__fmul_rn / __fadd_rn), which also makes the result
// bit-equal to the plain PyTorch version (kernels/lut_build.py,
// `build_luts_plain`).
//
// Design: a block owns one subspace m and a group of PAIRS_PER_BLOCK
// output rows.  Thread j keeps codeword cb[m, j] in registers (read from
// device memory once per block), the group's residual sub-vectors sit in
// shared memory, and each row's 256 entries of subspace m are written as
// one coalesced 1 KB store.  With a `rows` list, output row i is the table
// of residual rows[i]: the query path passes the pairs its plan filled, so
// the power-of-two padding of the pair capacity costs no table.
//
// Wide sub-spaces (any other dsub, e.g. 512 for a 4096-wide LM hidden state
// split into M = 8): `lut_build_wide_kernel`.  What bounds it: latency and
// FP32 issue.  At the LM retrieval's 32 pairs x M = 8 x dsub 512 it does
// 3 x 65,536 x 512 = 100.7M FP32 instructions (3.0 us on 132 SMs) over a 4 MB
// codebook and 512 KB of residuals: too little work to hide a chain of
// loads.  Design: the grid is cut over (sub-space m, group of CW codewords,
// group of PG pairs), sized by the launch plan (kernels/lut_build.py
// `wide_plan`, its Python twin) to fill the card with the least L2 traffic
// (each codeword row is read by every pair group, each residual by every
// codeword group): 16 x 16 and 256 blocks at the LM shape.  A block copies
// its codeword rows and its pairs' residual sub-vectors into shared memory
// with `cp.async` (16 bytes where addresses and dsub allow, else 8 or 4; a
// warp per row, its lanes over the row), slice by slice of up to 128
// coordinates, all slices that fit its budget in flight at once (the
// codewords' before the `rows` list has been read).  Thread (tp, tc) owns
// the entry of pair tp and codeword tc and reads four coordinates at a time
// of each of its two rows (LDS.128; rows padded so that eight consecutive
// rows fall on distinct banks).  One entry a thread, not a tile of them:
// at the LM shape the 65,536 entries then make four warps on each of an
// SM's four schedulers, which hide each other's add latencies (a 2 x 2
// tile a thread left one warp a scheduler, and took twice as long on an
// H100).  The running sum stays in a register across slices,
// so every entry still adds its terms in coordinate order from 0 and the
// result is bit-equal to the plain version.
// Threads of pairs past the last compute on stale shared memory and write
// nothing.

#include <cuda_runtime.h>

#include <climits>

#include "async_copy.cuh"

namespace {

constexpr int NCODES = 256;
constexpr int PAIRS_PER_BLOCK = 32;

template <int DSUB>
__global__ void __launch_bounds__(NCODES)
lut_build_kernel(const float* __restrict__ codebook,  // (M, 256, DSUB)
                 const float* __restrict__ qmc,       // (N, M, DSUB)
                 const int* __restrict__ rows,        // (P,) or null
                 float* __restrict__ out,             // (P, M, 256)
                 int n_pairs, int m) {
  __shared__ float res[PAIRS_PER_BLOCK * DSUB];
  const int mi = blockIdx.y;
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * PAIRS_PER_BLOCK;
  const int np = min(PAIRS_PER_BLOCK, n_pairs - p0);

  float cb[DSUB];
  const float* cbp = codebook + (static_cast<size_t>(mi) * NCODES + j) * DSUB;
#pragma unroll
  for (int d = 0; d < DSUB; ++d) cb[d] = cbp[d];
  for (int i = threadIdx.x; i < np * DSUB; i += blockDim.x) {
    const int pp = i / DSUB;
    const int d = i - pp * DSUB;
    const int src = rows ? rows[p0 + pp] : p0 + pp;
    res[i] = qmc[(static_cast<size_t>(src) * m + mi) * DSUB + d];
  }
  __syncthreads();

  for (int pp = 0; pp < np; ++pp) {
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < DSUB; ++d) {
      const float diff = __fsub_rn(res[pp * DSUB + d], cb[d]);
      acc = __fadd_rn(acc, __fmul_rn(diff, diff));
    }
    out[(static_cast<size_t>(p0 + pp) * m + mi) * NCODES + j] = acc;
  }
}

// the wide kernel's launch plan (kernels/lut_build.py `wide_plan`)
struct WidePlan {
  int pg, cw, ncw, ds, n_slices, stages, stride, g;
};
constexpr int WIDE_THREADS = 256;  // one entry a thread: pg x cw <= 256

__global__ void __launch_bounds__(WIDE_THREADS)
lut_build_wide_kernel(const float* __restrict__ codebook,  // (M, 256, dsub)
                      const float* __restrict__ qmc,       // (N, M, dsub)
                      const int* __restrict__ rows,        // (P,) or null
                      float* __restrict__ out,             // (P, M, 256)
                      int n_pairs, int m, int dsub, WidePlan pl) {
  extern __shared__ __align__(16) float sm[];  // stages x (PG + CW) rows of `stride`
  __shared__ int s_src[32];                    // the block's residual rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, warps = blockDim.x >> 5;
  const int t = blockIdx.x / pl.ncw;
  const int j0 = (blockIdx.x - t * pl.ncw) * pl.cw;
  const int mi = t % m;
  const int p0 = t / m * pl.pg;
  const int np = min(pl.pg, n_pairs - p0);
  const int n_rows = pl.pg + pl.cw;
  const int stage = n_rows * pl.stride;  // floats

  // slice s of rows [r0, r1) of the block (pairs first, then codewords) into
  // slot sb: a warp per row, its lanes over the row's g-byte units
  auto issue = [&](int s, int sb, int r0, int r1) {
    const int d0 = s * pl.ds;
    const int bytes = min(pl.ds, dsub - d0) * 4;
    for (int r = r0 + warp; r < r1; r += warps) {
      const float* src;
      if (r < pl.pg) {
        if (r >= np) continue;
        src = qmc + (static_cast<size_t>(s_src[r]) * m + mi) * dsub + d0;
      } else {
        src = codebook + (static_cast<size_t>(mi) * NCODES + j0 + r - pl.pg) * dsub + d0;
      }
      char* dst = reinterpret_cast<char*>(sm + sb * stage + r * pl.stride);
      for (int o = lane * pl.g; o < bytes; o += 32 * pl.g)
        async_copy::unit(dst + o, reinterpret_cast<const char*>(src) + o, pl.g);
    }
  };

  const int S = pl.stages;
  for (int s = 0; s < S; ++s) issue(s, s, pl.pg, n_rows);  // codewords: no lookup first
  if (tid < np) s_src[tid] = rows ? rows[p0 + tid] : p0 + tid;
  __syncthreads();
  for (int s = 0; s < S; ++s) {  // group s: slice s's residuals (group 0 also the codewords)
    issue(s, s, 0, pl.pg);
    async_copy::commit();
  }

  // thread (tp, tc): pair tp, codeword tc; a warp's lanes share one or few pairs
  const bool computes = tid < pl.pg * pl.cw;
  const int tc = tid % pl.cw, tp = tid / pl.cw;
  float acc = 0.f;
  for (int c = 0; c < pl.n_slices; ++c) {
    async_copy::wait(min(S - 1, pl.n_slices - 1 - c));
    __syncthreads();
    if (computes) {
      const float* base = sm + (c % S) * stage;
      const float* r = base + tp * pl.stride;
      const float* cw = base + (pl.pg + tc) * pl.stride;
      const int w = min(pl.ds, dsub - c * pl.ds);
      int d = 0;
#pragma unroll 4
      for (; d + 4 <= w; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(r + d);
        const float4 x = *reinterpret_cast<const float4*>(cw + d);
        float diff = __fsub_rn(a.x, x.x);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        diff = __fsub_rn(a.y, x.y);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        diff = __fsub_rn(a.z, x.z);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        diff = __fsub_rn(a.w, x.w);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      for (; d < w; ++d) {
        const float diff = __fsub_rn(r[d], cw[d]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
    __syncthreads();  // slot c % S is consumed
    if (c + S < pl.n_slices) {
      issue(c + S, c % S, 0, n_rows);
      async_copy::commit();
    }
  }
  if (computes && tp < np) out[(static_cast<size_t>(p0 + tp) * m + mi) * NCODES + j0 + tc] = acc;
}

template <int DSUB>
void launch(const float* codebook, const float* qmc, const int* rows,
            float* out, int n_pairs, int m, cudaStream_t stream) {
  dim3 grid((n_pairs + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK, m);
  lut_build_kernel<DSUB><<<grid, NCODES, 0, stream>>>(codebook, qmc, rows,
                                                      out, n_pairs, m);
}

}  // namespace

// dsub in {1, 2, 4, 8, 16, 32}; `rows` may be null (output row i is
// residual row i).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int lut_build_launch(const void* codebook, const void* qmc,
                                const void* rows, void* out, int n_pairs,
                                int m, int dsub, void* stream) {
  if (n_pairs <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto cb = static_cast<const float*>(codebook);
  auto r = static_cast<const float*>(qmc);
  auto ix = static_cast<const int*>(rows);
  auto o = static_cast<float*>(out);
  switch (dsub) {
    case 1: launch<1>(cb, r, ix, o, n_pairs, m, s); break;
    case 2: launch<2>(cb, r, ix, o, n_pairs, m, s); break;
    case 4: launch<4>(cb, r, ix, o, n_pairs, m, s); break;
    case 8: launch<8>(cb, r, ix, o, n_pairs, m, s); break;
    case 16: launch<16>(cb, r, ix, o, n_pairs, m, s); break;
    case 32: launch<32>(cb, r, ix, o, n_pairs, m, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Any other dsub >= 1, cut by kernels/lut_build.py `wide_plan` (pg, cw,
// ds, n_slices, stages, stride, g, threads, smem).  `rows` may be null.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int lut_build_wide_launch(const void* codebook, const void* qmc,
                                     const void* rows, void* out, int n_pairs,
                                     int m, int dsub, int pg, int cw, int ds,
                                     int n_slices, int stages, int stride, int g,
                                     int threads, int smem, void* stream) {
  if (n_pairs <= 0) return 0;
  const long long blocks =
      static_cast<long long>(m) * (NCODES / cw) * ((n_pairs + pg - 1) / pg);
  if (dsub <= 0 || pg < 1 || pg > 32 || cw < 1 || NCODES % cw || pg * cw > threads ||
      threads > WIDE_THREADS || threads % 32 || stages < 1 || stages > 8 || stages > n_slices ||
      static_cast<long long>(n_slices) * ds < dsub || stride % 4 || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // set on every call: the attribute belongs to the current device
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lut_build_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const WidePlan pl{pg, cw, NCODES / cw, ds, n_slices, stages, stride, g};
  lut_build_wide_kernel<<<static_cast<int>(blocks), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(codebook), static_cast<const float*>(qmc),
      static_cast<const int*>(rows), static_cast<float*>(out), n_pairs, m, dsub, pl);
  return static_cast<int>(cudaGetLastError());
}
