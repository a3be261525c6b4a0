// Kernel B3: exact re-rank distances with the raw-vector gather fused in.
//
// Replaces: src/repro/kernels/rerank.py `rerank_dists_kernel`
//           (Pallas body `_rerank_dists_block`), together with the gather
//           by id and the one-owner psum around it in
//           src/repro/retrieval/search.py `_device_rerank`.
//
// For every (query q, candidate id c): look up the candidate's home device
// and row (id_dev[c], id_row[c]), read its raw row from that device's shard
// of the store (rows row_base[dev] ...), widen bf16 to f32 and reduce
// sum_d (x_d - q_d)^2 in f32.  Invalid candidates (c < 0, c beyond the id
// map, or unmapped) come back as +inf.  Each candidate is computed once,
// by its owner, so there is nothing to sum across devices: the reference's
// psum added the one nonzero partial to zeros, which this is bit-equal to.
//
// What bounds it on an H100: the gather.  At k' = 64, D = 128 and a bf16
// store a 1000-query batch reads 64k scattered 256-byte rows (16 MB), far
// too little to reach the memory rate; it is latency-bound.  Design: one
// warp per candidate, so each row is one 256-byte read spread over 32
// lanes; the query row sits in shared memory; 8 warps per block keep 8
// rows in flight, and the grid has a block per (query, block_k slice).
//
// Reduction order (fixed, and repeated by the plain PyTorch version in
// kernels/rerank.py so the two are bit-equal): lane l sums its contiguous
// ceil(D/32) coordinates in order, then a butterfly over the lanes with
// offsets 16, 8, 4, 2, 1.  No FMA contraction (__fmul_rn / __fadd_rn).
// A candidate's sum never reads another candidate, so block_k cannot
// change any bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rerank_kernel(const float* __restrict__ queries,     // (Q, D)
              const int* __restrict__ cand,          // (Q, K) global ids
              const int* __restrict__ id_dev,        // (ids_cap,)
              const int* __restrict__ id_row,        // (ids_cap,)
              const long long* __restrict__ row_base,  // (ndev,)
              const T* __restrict__ vectors,         // (rows, D)
              float* __restrict__ out,               // (Q, K)
              int K, int D, int ids_cap, int block_k) {
  extern __shared__ float qs[];
  const int q = blockIdx.x;
  for (int i = threadIdx.x; i < D; i += THREADS)
    qs[i] = queries[static_cast<size_t>(q) * D + i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int per = (D + 31) / 32;
  const int k0 = blockIdx.y * block_k;
  const int k1 = min(K, k0 + block_k);
  for (int kk = k0 + warp; kk < k1; kk += THREADS / 32) {
    const size_t o = static_cast<size_t>(q) * K + kk;
    const int c = cand[o];
    const int dev = (c >= 0 && c < ids_cap) ? id_dev[c] : -1;
    if (dev < 0) {
      if (lane == 0) out[o] = CUDART_INF_F;
      continue;
    }
    const T* row =
        vectors + static_cast<size_t>(row_base[dev] + id_row[c]) * D;
    float acc = 0.f;
    const int d0 = lane * per;
    for (int e = 0; e < per; ++e) {
      const int d = d0 + e;
      if (d < D) {
        const float diff = __fsub_rn(widen(row[d]), qs[d]);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[o] = acc;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rerank_launch(const void* queries, const void* cand,
                             const void* id_dev, const void* id_row,
                             const void* row_base, const void* vectors,
                             void* out, int q, int k, int d, int ids_cap,
                             int vec_is_bf16, int block_k, void* stream) {
  if (q <= 0 || k <= 0) return 0;
  if (block_k <= 0) block_k = k;
  dim3 grid(q, (k + block_k - 1) / block_k);
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec_is_bf16) {
    rerank_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(queries), static_cast<const int*>(cand),
        static_cast<const int*>(id_dev), static_cast<const int*>(id_row),
        static_cast<const long long*>(row_base),
        static_cast<const __nv_bfloat16*>(vectors), static_cast<float*>(out),
        k, d, ids_cap, block_k);
  } else {
    rerank_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(queries), static_cast<const int*>(cand),
        static_cast<const int*>(id_dev), static_cast<const int*>(id_row),
        static_cast<const long long*>(row_base),
        static_cast<const float*>(vectors), static_cast<float*>(out), k, d,
        ids_cap, block_k);
  }
  return static_cast<int>(cudaGetLastError());
}
