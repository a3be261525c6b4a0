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
// map, or unmapped) read nothing and come back as +inf.  Each candidate is
// computed once, by its owner, so there is nothing to sum across devices:
// the reference's psum added the one nonzero partial to zeros, which this
// is bit-equal to.
//
// What bounds it on an H100: latency and instruction issue, not bytes.  At
// k' = 64, D = 128 and a bf16 store a 1000-query batch reads 64,000
// scattered 256-byte rows (16 MB, 4.8 us at the memory rate), each behind
// two dependent lookups (its id, then its id-map entry); the LM retrieval
// reads 256 rows of 16 KB (D = 4096, an f32 store) for 4 queries.
//
// Design: a block of four warps takes `cpb` candidates of one query, sized
// by the launch plan (kernels/rerank.py `launch_plan`, its Python twin) so
// that the grid has at least two blocks an SM where Q x K allows: a whole
// query's 64 at the main path (1000 blocks, all resident at once, 8 an SM),
// one at the LM retrieval's 256.  A block's chain is three rounds: a
// thread per candidate loads its id, then its id-map entry, while another
// stages row_base in shared memory; then the warps issue all valid rows'
// copies into shared memory (`cp.async`, 16 bytes where the addresses and
// row lengths allow, else 8, 4 or 2; a warp per row), and sum once they
// land.  Whole rows arrive in two groups of candidates, so the second
// group's copies fly while the first is summed.  A row longer than 32 x 32
// coordinates arrives in chunks, up to 8 in flight in a ring; a chunk holds
// the same lane-local coordinates [c * pc, (c + 1) * pc) of every lane, so
// each lane keeps its order.  Lanes read their coordinates from shared
// memory `rv` bytes at a time, with lane segments padded where the reads
// would share banks.  The query's chunk arrives in the same slot (4-byte
// copies into lane segments an odd number of words apart) and moves into
// registers (8 or 32 a lane): read straight from device memory at a lane
// stride of D / 32 words it cost tens of microseconds at D = 4096.
//
// Reduction order (fixed, and repeated by the plain PyTorch version in
// kernels/rerank.py so the two are bit-equal): lane l sums its contiguous
// ceil(D/32) coordinates in order, then the 32 partials fold as a
// butterfly over the lanes with offsets 16, 8, 4, 2, 1 leaves them in lane
// 0.  The kernel folds without shuffles: the lanes store their partials in
// shared memory and a thread per candidate adds them in that tree (a
// shuffle butterfly per candidate keeps the SM's shuffle pipe busy at the
// main path's 64,000 candidates).  No FMA contraction (__fsub_rn /
// __fmul_rn / __fadd_rn).  A candidate's sum never reads another
// candidate, so candidates per block (and `block_k`, which caps them)
// cannot change any bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstring>

#include "async_copy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CAND_MAX = 64;           // candidates a block (kernels/rerank.py)
constexpr int CPW = CAND_MAX / WARPS;  // candidates a warp
static_assert(CAND_MAX <= THREADS, "one thread loads each candidate's id");
constexpr int RB_MAX = 256;            // row_base entries staged in shared memory
constexpr int PART_STRIDE = 36;        // floats between candidates' lane partials (9 quads, odd)

// the launch plan's numbers (kernels/rerank.py `launch_plan`)
struct Plan {
  int per, pc, n_chunks, seg, segq, contig, g, cpb, nkb, stages;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int RV> struct Piece;
template <> struct Piece<16> { using type = uint4; };
template <> struct Piece<8> { using type = uint2; };
template <> struct Piece<4> { using type = unsigned; };
template <> struct Piece<2> { using type = unsigned short; };

// T: the store's type; RV: bytes of a lane's shared-memory read; QREG:
// query coordinates a lane holds (>= the plan's pc; with 8 a block keeps to
// 64 registers a thread, so that 8 blocks fit an SM); FULL: every lane owns
// whole chunks of coordinates (D = 32 per, pc divides per), so no
// coordinate needs a bound check.
template <typename T, int RV, int QREG, bool FULL>
__global__ void __launch_bounds__(THREADS, QREG == 8 ? 8 : 4)
rerank_kernel(const float* __restrict__ queries,       // (Q, D)
              const int* __restrict__ cand,            // (Q, K) global ids
              const int* __restrict__ id_dev,          // (ids_cap,)
              const int* __restrict__ id_row,          // (ids_cap,)
              const long long* __restrict__ row_base,  // (ndev,)
              const T* __restrict__ vectors,           // (rows, D)
              float* __restrict__ out,                 // (Q, K)
              int K, int D, int ids_cap, int ndev, Plan pl) {
  constexpr int E = sizeof(T);
  constexpr int VE = RV / E;  // coordinates a read
  extern __shared__ __align__(16) char buf[];
  __shared__ long long s_row[CAND_MAX];  // store row of each candidate, -1 invalid
  __shared__ long long s_rb[RB_MAX];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qi = blockIdx.x / pl.nkb;
  const int k0 = (blockIdx.x - qi * pl.nkb) * pl.cpb;
  const int nc = min(pl.cpb, K - k0);

  // rounds 1 and 2: the ids, then their id-map entries; row_base meanwhile
  int dev = -1, rr = 0;
  if (tid < nc) {
    const int c = cand[static_cast<size_t>(qi) * K + k0 + tid];
    if (c >= 0 && c < ids_cap) {
      dev = id_dev[c];
      rr = id_row[c];
    }
  }
  for (int i = tid; i < min(ndev, RB_MAX); i += THREADS) s_rb[i] = row_base[i];
  __syncthreads();
  if (tid < nc) s_row[tid] = dev < 0 ? -1 : (dev < RB_MAX ? s_rb[dev] : row_base[dev]) + rr;
  __syncthreads();

  // round 3: chunk c of the query and of every valid row into ring slot sb:
  // the query's 32 lane segments (f32, segq words apart, segq odd; warp 0,
  // each lane its own), then the candidates' rows (a warp per row, its
  // lanes over the row's g-byte units, or each lane its own segment)
  const size_t row_bytes = static_cast<size_t>(D) * E;
  const int q_bytes = 32 * pl.segq * 4;
  const int cand_bytes = 32 * pl.seg;
  const int stage_bytes = q_bytes + pl.cpb * cand_bytes;
  const char* vb = reinterpret_cast<const char*>(vectors);
  const float* qrow = queries + static_cast<size_t>(qi) * D;
  auto issue = [&](int c, int sb, int ja, int jb) {  // candidates [ja, jb), the query with ja = 0
    const int lenc = min(pl.pc, pl.per - c * pl.pc);
    const int d0 = lane * pl.per + c * pl.pc;
    if (warp == 0 && ja == 0) {
      float* qdst = reinterpret_cast<float*>(buf + sb * stage_bytes) + lane * pl.segq;
      for (int e = 0; e < lenc && d0 + e < D; ++e) async_copy::unit(qdst + e, qrow + d0 + e, 4);
    }
    char* dst = buf + sb * stage_bytes + q_bytes;
    for (int j = ja + warp; j < jb; j += WARPS) {
      const long long row = s_row[j];
      if (row < 0) continue;
      const char* src = vb + row * row_bytes;
      char* to = dst + j * cand_bytes;
      if (pl.contig) {  // the whole row, as it lies in the store
        for (int o = lane * pl.g; o < static_cast<int>(row_bytes); o += 32 * pl.g)
          async_copy::unit(to + o, src + o, pl.g);
      } else {  // lane `lane`'s segment of chunk c
        const int len = min(lenc, D - d0) * E;
        for (int o = 0; o < len; o += pl.g)
          async_copy::unit(to + lane * pl.seg + o, src + static_cast<size_t>(d0) * E + o, pl.g);
      }
    }
  };

  const int S = pl.stages;
  const int mine = (nc - warp + WARPS - 1) / WARPS;  // this warp's candidates j = warp + i * WARPS
  float acc[CPW];
#pragma unroll
  for (int i = 0; i < CPW; ++i) acc[i] = 0.f;
  float qv[QREG];
  // chunk c (in slot c % S) of the warp's candidates i in [i0, i1)
  auto sum = [&](int c, int i0, int i1) {
    const int lenc = min(pl.pc, pl.per - c * pl.pc);  // lane-local coordinates of chunk c
    const int d0 = lane * pl.per + c * pl.pc;
    const char* sbuf = buf + (c % S) * stage_bytes + q_bytes + lane * pl.seg;
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int j = warp + i * WARPS;
      if (i >= i0 && i < i1 && i < mine && s_row[j] >= 0) {
        const char* p = sbuf + j * cand_bytes;
        float a = acc[i];
#pragma unroll
        for (int e0 = 0; e0 < QREG; e0 += VE) {
          if (e0 < lenc) {
            const typename Piece<RV>::type raw =
                *reinterpret_cast<const typename Piece<RV>::type*>(p + e0 * E);
            T x[VE];
            memcpy(x, &raw, RV);
#pragma unroll
            for (int v = 0; v < VE; ++v) {
              if (FULL || d0 + e0 + v < D) {
                const float diff = __fsub_rn(widen(x[v]), qv[e0 + v]);
                a = __fadd_rn(a, __fmul_rn(diff, diff));
              }
            }
          }
        }
        acc[i] = a;
      }
    }
  };
  auto load_query = [&](int c) {  // chunk c of the query's coordinates of this lane
    const int lenc = min(pl.pc, pl.per - c * pl.pc);
    const int d0 = lane * pl.per + c * pl.pc;
    const float* qs = reinterpret_cast<const float*>(buf + (c % S) * stage_bytes) + lane * pl.segq;
#pragma unroll
    for (int e = 0; e < QREG; ++e) qv[e] = (e < lenc && (FULL || d0 + e < D)) ? qs[e] : 0.f;
  };

  if (pl.n_chunks == 1) {
    // whole rows in two groups of candidates: the second group's copies fly
    // while the first group (warp w's candidates i < CPW / 2) is summed
    constexpr int JH = WARPS * (CPW / 2);
    issue(0, 0, 0, min(nc, JH));
    async_copy::commit();
    issue(0, 0, JH, nc);
    async_copy::commit();
    async_copy::wait(1);
    __syncthreads();
    load_query(0);
    sum(0, 0, CPW / 2);
    async_copy::wait(0);
    __syncthreads();
    sum(0, CPW / 2, CPW);
  } else {
    for (int s = 0; s < S; ++s) {
      issue(s, s, 0, nc);
      async_copy::commit();
    }
    for (int c = 0; c < pl.n_chunks; ++c) {
      async_copy::wait(min(S - 1, pl.n_chunks - 1 - c));
      __syncthreads();
      load_query(c);
      sum(c, 0, CPW);
      __syncthreads();  // slot c % S is consumed
      if (c + S < pl.n_chunks) {
        issue(c + S, c % S, 0, nc);
        async_copy::commit();
      }
    }
  }

  // the fold: each lane's partial into shared memory (over the consumed
  // ring), then a thread per candidate adds the 32 in the butterfly's tree
  // (offsets 16, 8, 4, 2, 1 as seen from lane 0), and the writes coalesce
  __syncthreads();
  float* part = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int i = 0; i < CPW; ++i)
    if (i < mine) part[(warp + i * WARPS) * PART_STRIDE + lane] = acc[i];
  __syncthreads();
  if (tid < nc) {
    const float* pp = part + tid * PART_STRIDE;
    float v[32];
#pragma unroll
    for (int l = 0; l < 32; l += 4) {
      const float4 x = *reinterpret_cast<const float4*>(pp + l);
      v[l] = x.x;
      v[l + 1] = x.y;
      v[l + 2] = x.z;
      v[l + 3] = x.w;
    }
#pragma unroll
    for (int l = 0; l < 16; ++l) v[l] = __fadd_rn(v[l], v[l + 16]);
#pragma unroll
    for (int l = 0; l < 8; ++l) v[l] = __fadd_rn(v[l], v[l + 8]);
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = __fadd_rn(v[l], v[l + 4]);
    v[0] = __fadd_rn(v[0], v[2]);
    v[1] = __fadd_rn(v[1], v[3]);
    v[0] = __fadd_rn(v[0], v[1]);
    out[static_cast<size_t>(qi) * K + k0 + tid] = s_row[tid] < 0 ? CUDART_INF_F : v[0];
  }
}

template <typename T, int RV, int QREG, bool FULL>
int launch(const void* queries, const void* cand, const void* id_dev, const void* id_row,
           const void* row_base, const void* vectors, void* out, int q, int k, int d,
           int ids_cap, int ndev, const Plan& pl, int smem, cudaStream_t s) {
  rerank_kernel<T, RV, QREG, FULL><<<q * pl.nkb, THREADS, smem, s>>>(
      static_cast<const float*>(queries), static_cast<const int*>(cand),
      static_cast<const int*>(id_dev), static_cast<const int*>(id_row),
      static_cast<const long long*>(row_base), static_cast<const T*>(vectors),
      static_cast<float*>(out), k, d, ids_cap, ndev, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int QREG, bool FULL>
int launch_rv(int rv, const void* queries, const void* cand, const void* id_dev,
              const void* id_row, const void* row_base, const void* vectors, void* out, int q,
              int k, int d, int ids_cap, int ndev, const Plan& pl, int smem, cudaStream_t s) {
#define RERANK_CASE(RV)                                                                    \
  case RV:                                                                                 \
    return launch<T, RV, QREG, FULL>(queries, cand, id_dev, id_row, row_base, vectors, out, \
                                     q, k, d, ids_cap, ndev, pl, smem, s);
  switch (rv) {
    RERANK_CASE(16)
    RERANK_CASE(8)
    RERANK_CASE(4)
    default:
      if constexpr (sizeof(T) == 2) {
        if (rv == 2)
          return launch<T, 2, QREG, FULL>(queries, cand, id_dev, id_row, row_base, vectors, out,
                                          q, k, d, ids_cap, ndev, pl, smem, s);
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RERANK_CASE
}

template <typename T, int QREG>
int launch_full(int rv, bool full, const void* queries, const void* cand, const void* id_dev,
                const void* id_row, const void* row_base, const void* vectors, void* out, int q,
                int k, int d, int ids_cap, int ndev, const Plan& pl, int smem, cudaStream_t s) {
  if (full)
    return launch_rv<T, QREG, true>(rv, queries, cand, id_dev, id_row, row_base, vectors, out,
                                    q, k, d, ids_cap, ndev, pl, smem, s);
  return launch_rv<T, QREG, false>(rv, queries, cand, id_dev, id_row, row_base, vectors, out, q,
                                   k, d, ids_cap, ndev, pl, smem, s);
}

}  // namespace

// `plan` holds kernels/rerank.py `launch_plan`'s numbers in the order of
// `rerank.PLAN_FIELDS`: the fields of Plan, then rv, qreg and smem (within
// the 48 KB a launch may take without cudaFuncSetAttribute).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int rerank_launch(const void* queries, const void* cand, const void* id_dev,
                             const void* id_row, const void* row_base, const void* vectors,
                             void* out, int q, int k, int d, int ids_cap, int ndev,
                             int vec_is_bf16, const int* plan, void* stream) {
  if (q <= 0 || k <= 0) return 0;
  const Plan pl{plan[0], plan[1], plan[2], plan[3], plan[4],
                plan[5], plan[6], plan[7], plan[8], plan[9]};
  const int rv = plan[10], qreg = plan[11], smem = plan[12];
  const int per = pl.per, pc = pl.pc, cpb = pl.cpb, nkb = pl.nkb, stages = pl.stages;
  if (cpb < 1 || cpb > CAND_MAX || stages < 1 || stages > 8 || stages > pl.n_chunks ||
      pc > qreg || pl.segq < pc || smem > 48 * 1024 ||
      static_cast<long long>(q) * nkb > INT_MAX || static_cast<long long>(nkb) * cpb < k)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const bool full = d == 32 * per && per % pc == 0;
  if (vec_is_bf16) {
    if (qreg == 8)
      return launch_full<__nv_bfloat16, 8>(rv, full, queries, cand, id_dev, id_row, row_base,
                                           vectors, out, q, k, d, ids_cap, ndev, pl, smem, s);
    return launch_full<__nv_bfloat16, 32>(rv, full, queries, cand, id_dev, id_row, row_base,
                                          vectors, out, q, k, d, ids_cap, ndev, pl, smem, s);
  }
  if (qreg == 8)
    return launch_full<float, 8>(rv, full, queries, cand, id_dev, id_row, row_base, vectors, out,
                                 q, k, d, ids_cap, ndev, pl, smem, s);
  return launch_full<float, 32>(rv, full, queries, cand, id_dev, id_row, row_base, vectors, out,
                                q, k, d, ids_cap, ndev, pl, smem, s);
}
