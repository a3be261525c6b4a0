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
// split into M = 8): `lut_build_wide_kernel` walks dsub in slices of 32
// for a group of WIDE_PAIRS = 4 rows (small groups: a 4-query LM batch
// fills only 32 pairs).  The block stages each slice of its sub-space's
// 256 codewords, and of the group's residuals, in shared memory with
// coalesced loads, and fetches the next slice into registers while it sums
// the current one: the 16 slices of dsub 512 are a chain, so the block's
// time is 16 load round trips unless they overlap.  Thread j copies the
// slice of codeword j into registers, and each row keeps its running sum
// in a register across slices, so the terms are still added in coordinate
// order from 0 and the result stays bit-equal to the plain version.  Rows
// past the last pair (np < 4) sum stale shared memory and are not written.

#include <cuda_runtime.h>

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

constexpr int SLICE = 32;
constexpr int WIDE_PAIRS = 4;
constexpr int ROW_STEP = NCODES / SLICE;  // codeword rows staged per pass

// Thread (c0, dl) of the block's 8 x 32 grid loads column dl of the slice
// at d0 of codeword rows c0, c0 + 8, ..., c0 + 248, and, if c0 names one of
// the group's rows, that residual's column dl: 33 loads in flight at once.
__device__ __forceinline__ void fetch_slice(const float* __restrict__ cbm,
                                            const float* __restrict__ res_row,
                                            int dsub, int d0, int c0, int dl,
                                            float (&cbn)[SLICE], float& rn) {
  const bool live = dl < dsub - d0;
#pragma unroll
  for (int r = 0; r < SLICE; ++r)
    cbn[r] = live ? cbm[static_cast<size_t>(c0 + r * ROW_STEP) * dsub + d0 + dl] : 0.f;
  if (res_row != nullptr) rn = live ? res_row[d0 + dl] : 0.f;
}

__global__ void __launch_bounds__(NCODES)
lut_build_wide_kernel(const float* __restrict__ codebook,  // (M, 256, dsub)
                      const float* __restrict__ qmc,       // (N, M, dsub)
                      const int* __restrict__ rows,        // (P,) or null
                      float* __restrict__ out,             // (P, M, 256)
                      int n_pairs, int m, int dsub) {
  __shared__ float res[WIDE_PAIRS * SLICE];
  __shared__ float cbs[NCODES * (SLICE + 1)];  // padded: conflict-free rows
  const int mi = blockIdx.y;
  const int j = threadIdx.x;
  const int p0 = blockIdx.x * WIDE_PAIRS;
  const int np = min(WIDE_PAIRS, n_pairs - p0);
  const int c0 = j / SLICE;
  const int dl = j - c0 * SLICE;
  const float* cbm = codebook + static_cast<size_t>(mi) * NCODES * dsub;
  const float* res_row = nullptr;
  if (c0 < np) {
    const int src = rows ? rows[p0 + c0] : p0 + c0;
    res_row = qmc + (static_cast<size_t>(src) * m + mi) * dsub;
  }

  float acc[WIDE_PAIRS];
#pragma unroll
  for (int pp = 0; pp < WIDE_PAIRS; ++pp) acc[pp] = 0.f;
  float cbn[SLICE];
  float rn = 0.f;
  fetch_slice(cbm, res_row, dsub, 0, c0, dl, cbn, rn);
  for (int d0 = 0; d0 < dsub; d0 += SLICE) {
    const int w = min(SLICE, dsub - d0);
    __syncthreads();  // the previous slice is consumed
    if (res_row != nullptr) res[j] = rn;
#pragma unroll
    for (int r = 0; r < SLICE; ++r) cbs[(c0 + r * ROW_STEP) * (SLICE + 1) + dl] = cbn[r];
    __syncthreads();
    // the next slice's loads fly while this one is summed
    if (d0 + SLICE < dsub) fetch_slice(cbm, res_row, dsub, d0 + SLICE, c0, dl, cbn, rn);
    float cb[SLICE];
#pragma unroll
    for (int d = 0; d < SLICE; ++d) cb[d] = cbs[j * (SLICE + 1) + d];
    // coordinate-major, so the rows' sums are independent chains
#pragma unroll
    for (int d = 0; d < SLICE; ++d) {
      if (d < w) {
#pragma unroll
        for (int pp = 0; pp < WIDE_PAIRS; ++pp) {
          const float diff = __fsub_rn(res[pp * SLICE + d], cb[d]);
          acc[pp] = __fadd_rn(acc[pp], __fmul_rn(diff, diff));
        }
      }
    }
  }
#pragma unroll
  for (int pp = 0; pp < WIDE_PAIRS; ++pp)
    if (pp < np) out[(static_cast<size_t>(p0 + pp) * m + mi) * NCODES + j] = acc[pp];
}

template <int DSUB>
void launch(const float* codebook, const float* qmc, const int* rows,
            float* out, int n_pairs, int m, cudaStream_t stream) {
  dim3 grid((n_pairs + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK, m);
  lut_build_kernel<DSUB><<<grid, NCODES, 0, stream>>>(codebook, qmc, rows,
                                                      out, n_pairs, m);
}

}  // namespace

// `rows` may be null (output row i is residual row i).  Returns
// cudaGetLastError() after the launch (0 = launched).
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
    default: {
      if (dsub <= 0) return static_cast<int>(cudaErrorInvalidValue);
      dim3 grid((n_pairs + WIDE_PAIRS - 1) / WIDE_PAIRS, m);
      lut_build_wide_kernel<<<grid, NCODES, 0, s>>>(cb, r, ix, o, n_pairs, m, dsub);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
