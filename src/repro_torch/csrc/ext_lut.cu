// Kernels B4 and B9: the extended tables of co-occurrence encoding (§4.3),
// out[r] = [LUT row r (M*256) | combo sums (n_combos) | 0 ... up to t_pad].
//
// Replaces: src/repro/kernels/lut_build.py `ext_lut_pairs_kernel` (B4, each
//           pair brings its cluster's combo set) and `ext_lut_kernel` (B9,
//           one combo set shared by all rows); both Pallas bodies are
//           `_ext_lut_kernel`.
//
// One CUDA kernel serves both: a block per output row copies the row's
// table (written by B1, one row per filled pair) into the output and into
// shared memory, then thread s sums combo s's L table entries, read at its
// flat addresses (col * 256 + code), with __fadd_rn in index order -- so
// the plain versions in kernels/lut_build.py are bit-equal.  B4 reads the
// combo set `set_idx[r]` of the (n_sets, n_combos, L) address tables (the
// wrapper passes dev * S + pair_slot, i.e. combo_addrs[dev, pair_slot]);
// B9 passes no set_idx and every row reads set 0 (combo stride 0).  The
// last entry of the table is the zero the sentinel address points at.
// A table of M * 256 floats wider than a block's 227 KB of shared memory
// (M >= 228; uint16 addresses allow M * 256 + n_combos + 1 <= 65,536) is
// read where it lies instead (the GTAB instantiation; the same sums).
//
// What bounds it on an H100: bytes.  Per row it reads 16 KB of table and
// n_combos * L addresses (3 KB, shared by the rows of a cluster and mostly
// from L2) and writes (M*256 + n_combos + 1) * 4 B: 64,000 pairs x 4353
// entries = 1.1 GB per 1000-query batch at SIFT geometry, against a few
// hundred operations per row.  Fusing B1 into it (building the LUT row
// in place instead of reading it back) would save the 1 GB round trip of
// the tables; that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool GTAB>
__global__ void __launch_bounds__(THREADS)
ext_lut_kernel(const float* __restrict__ luts,     // (R, MA)
               const int* __restrict__ set_idx,    // (R,) or null
               const int* __restrict__ caddr,      // (n_sets, n_combos, L)
               float* __restrict__ out,            // (R, t_pad)
               int ma, int n_combos, int combo_len, int t_pad) {
  extern __shared__ float lut[];
  const int r = blockIdx.x;
  const float* src = luts + static_cast<size_t>(r) * ma;
  float* dst = out + static_cast<size_t>(r) * t_pad;
  for (int i = threadIdx.x; i < ma; i += THREADS) {
    const float v = src[i];
    if constexpr (!GTAB) lut[i] = v;
    dst[i] = v;
  }
  __syncthreads();
  const float* tab = GTAB ? src : lut;
  const int set = set_idx ? set_idx[r] : 0;
  const int* ca = caddr + static_cast<size_t>(set) * n_combos * combo_len;
  for (int s = threadIdx.x; s < n_combos; s += THREADS) {
    float acc = 0.f;
    for (int l = 0; l < combo_len; ++l) acc = __fadd_rn(acc, tab[ca[s * combo_len + l]]);
    dst[ma + s] = acc;
  }
  for (int i = ma + n_combos + threadIdx.x; i < t_pad; i += THREADS) dst[i] = 0.f;
}

template <bool GTAB>
int launch(const void* luts, const void* set_idx, const void* caddr, void* out, int n_rows,
           int ma, int n_combos, int combo_len, int t_pad, cudaStream_t stream) {
  const size_t smem = GTAB ? 0 : static_cast<size_t>(ma) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ext_lut_kernel<GTAB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ext_lut_kernel<GTAB><<<n_rows, THREADS, smem, stream>>>(
      static_cast<const float*>(luts), static_cast<const int*>(set_idx),
      static_cast<const int*>(caddr), static_cast<float*>(out), ma, n_combos,
      combo_len, t_pad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// set_idx may be null (every row reads combo set 0); gtab nonzero: the
// combo sums read the row's table where it lies in device memory (a table
// of M * 256 floats wider than a block's shared memory), else a copy in
// shared memory.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ext_lut_launch(const void* luts, const void* set_idx,
                              const void* caddr, void* out, int n_rows, int ma,
                              int n_combos, int combo_len, int t_pad, int gtab,
                              void* stream) {
  if (n_rows <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  return gtab ? launch<true>(luts, set_idx, caddr, out, n_rows, ma, n_combos, combo_len, t_pad, st)
              : launch<false>(luts, set_idx, caddr, out, n_rows, ma, n_combos, combo_len, t_pad, st);
}
