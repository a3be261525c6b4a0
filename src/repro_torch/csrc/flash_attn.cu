// Kernel B10: causal GQA flash-attention forward, online softmax in f32,
// both products on the tensor cores in split TF32.
//
// Replaces: src/repro/kernels/flash_attn.py `flash_attention_fwd`
//           (Pallas body `_flash_fwd_kernel`), the prefill path of
//           src/repro/models/layers.py `gqa_attention`.
//
// What it computes, per query head h (KV head h / (H / KV)) and query row
// i at absolute position q_offset + i: key j is live iff j <= q_offset + i
// and j < kv_valid; the scores are scale * (q . k_j) and the row's output
// is sum_j softmax(scores)_j v_j by an online softmax over key tiles:
// running max m (with the reference's -inf guard: m_safe = 0 while m is
// -inf), running sum l, f32 accumulator, out = acc / max(l, 1e-30) in q's
// dtype.  A row that never sees a live key gives 0.  q may be bf16 or f32,
// k / v bf16 or f32 independently (the serving path reads a bf16 q against
// an f32 cache).  The reference scales q before the dot; here the scale
// multiplies the f32 score after it, which keeps a bf16 q exact in TF32
// (the two differ by f32 rounding of the summands, ~2^-24 relative).
//
// What bounds it on an H100: operations.  At the qwen3-8b prefill shape
// (B 4, S 2048, H 32, KV 8, hd 128) the causal pairs need B * H * hd *
// 2,098,176 = 34.4 G multiply-adds per product, 137.5 GFLOP for the two,
// against ~0.2 GB of Q, O and K/V (0.06 ms at 3.35 TB/s).  On the CUDA
// cores that is 2.05 ms at 33.5 T FMA/s; on the tensor cores in TF32
// (495 TFLOP/s dense) one pass of both products is 0.278 ms, and the split
// below runs 2 passes of Q.K^T and 3 of P.V for a bf16 q and an f32
// cache: 343.7 GFLOP, 0.694 ms.  The kernel issues `mma.sync` (m16n8k8,
// TF32), not `wgmma`: wgmma takes TF32 operands only K-major from shared
// memory, so the hi / lo halves of K and of V (stored transposed) would
// both live there, 64 KB per operand per 64-key stage at hd 128, and a
// double-buffered K / V ring would not fit in 227 KB; with mma.sync each
// warp splits its fragments in registers from one f32 tile.  mma.sync
// reaches 257-269 TFLOP/s in TF32 on the H100 (tools/probe_tf32_mma.cu),
// so this design's floor is 1.28 ms; it runs at about half of that (2.36
// ms, PERF.md): per warp and 64-key tile ~640 MMAs beside ~420 shared
// loads and ~2.5 K integer / f32 instructions (the splits, the softmax,
// the f32 adds), with 8 warps per SM (255 registers each) and the warps
// in step at each tile's barriers.
//
// Error argument (split precision).  TF32 keeps 11 significant bits.  An
// f32 x splits as hi = rna_tf32(x) (round to nearest, ties away; the bit
// operations below equal `cvt.rna.tf32.f32` for finite x) and lo = x - hi,
// exact in f32 with |lo| <= 2^-11 |x|; the tensor core reads lo's top 11
// bits, so lo loses at most 2^-10 |lo| <= 2^-21 |x|.  A bf16 value is exact
// in TF32 (8 <= 11 bits) and is not split.  Products: Q.K^T takes q.k_hi +
// q.k_lo for a bf16 q (f32 q: q_hi.k_hi + q_hi.k_lo + q_lo.k_hi; bf16 k:
// q_hi.k + q_lo.k); P.V takes p_hi.v_hi + p_hi.v_lo + p_lo.v_hi (bf16 v:
// p_hi.v + p_lo.v).  What the split drops (lo rounding, lo.lo) is <=
// ~2^-20 of |q_d k_d| or |p_j v_jd| per term and of both signs; a score
// error d moves p by a factor exp(d).  Emulated on the plain version's
// blocks with exact sums (tests/test_torch_flash_attn.py), the split's
// operand rounding uses 0.02 of the f32-q tolerance (rtol 1e-4, atol
// 1e-5) with normal scores and 0.08 with the largest logit at 30; a single
// TF32 pass uses 46x and 600x of it.
//
// Sums.  The instruction adds its 8 products and the accumulator with
// truncation at ~2^-23 of the largest addend (tools/probe_tf32_mma.cu:
// mean error -0.41 ulp of it, toward zero, at most 2.8).  Chaining a
// whole product in the accumulator (16 head-dim steps x 2-3 passes for a
// score, every tile's P.V for the output) compounds that bias: such a
// first version used 1.61 of the f32-q tolerance against float64 in the
// peaked case.  So each chain here is short and lands in an f32 register
// by a rounding add: Q.K^T chains 4 head-dim steps (2 at hd 16 and 112,
// whose 2 and 14 steps 4 does not divide), P.V one
// tile's 8 key steps, each from zero.  Measured at the prefill's shape (PERF.md) the
// kernel then uses 0.04 (normal) and 0.51 (peaked) of the f32-q tolerance
// against the same function in float64, where the f32 plain version uses
// 0.07 and 1.38: with logits near 30 the plain version's own f32 sums
// exceed the tolerance, so the peaked case is checked against float64.
// Values within 2^-11 of FLT_MAX round to inf in the split; the f32
// arithmetic of the plain version overflows near there too.
//
// Design.  On the TPU the KV axis is the innermost sequential grid axis,
// carrying m, l and acc in VMEM scratch.  Here it is a loop inside the
// block.  GQA packing: one block serves all `groups` query heads of one
// KV head, 128 (position, head) rows ordered position-major (32 positions x
// 4 heads at GQA 4), so each K / V tile is staged once per group; blocks
// are launched longest causal rows first.  8 warps own 16 rows each (one
// m16 tile).  The block's Q rows (raw, in q's dtype) sit in shared memory;
// 64-key K and V tiles (raw, in the cache's dtype) arrive by `cp.async`
// into a two-stage ring, the next tile loading while this one computes.
// Per tile a warp computes S = Q.K^T (16 x 64) into registers, applies the
// scale, the mask and the online softmax there (row max / sum over the 4
// lanes that share a row), rescales its 16 x hd accumulator, and feeds
// P straight from S's registers as the A operand of P.V: the key order
// inside each 8-key step is permuted (logical k = t <-> key 2t, k = t + 4
// <-> key 2t + 1) so that the accumulator layout of S is the A layout of
// P, with no shuffles and no shared-memory round trip; V's B fragments are
// read with the same permutation.  The head dim of Q.K^T is permuted the
// same way, so Q and K fragments load as 8-byte pairs.  Row strides (hd + 8
// elements; hd + 4 for an f32 V) make every fragment load conflict-free.
// Key tiles past min(kv_valid, q_offset + last row + 1) are neither loaded
// nor visited (the reference's `any_live` skip, on the kernel's own tiles),
// a warp skips tiles past its own rows' last live key, and keys past that
// bound inside the last tile are zero-filled.  The Pallas blocks `bq` /
// `bk` (VMEM sizes) do not apply here: the wrapper checks them as the
// reference does and the plain version (kernels/flash_attn.py) honours
// them; the kernel ignores them.  Exponentials are expf (not __expf); the
// final division is a division.  The grid is one-dimensional: blockIdx.x
// lists (row tile, batch x KV head), so any number of row tiles launches
// (the y axis stops at 65,535).
//
// Every head dim and alignment.  The kernel above is instantiated for the
// registry's head dims (16 ... 128) and reads 16-byte chunks.  Any other
// head dim, and tensors not 16-byte aligned, run `flash_fwd_general_kernel`
// (kernels/flash_attn.py `kernel_variant`): the same tiles, products,
// chains, softmax and sums through the same helpers, with operands copied
// element by element (zero past hd), the head dim in slices of 64 or 128
// and, past 128, the output columns in blocks on grid y (each block forms
// the full scores and accumulates its own columns of P.V).  There is no
// CUDA-core body.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;            // (position, head) rows per block
constexpr int BK = 64;             // keys per tile
constexpr int WARPS = BM / 16;     // one m16 tile per warp
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;          // K / V ring depth
// head-dim steps of Q.K^T whose TF32 passes chain inside the tensor core
// before one f32 add into the scores (see "Sums" above); P.V chains a
// tile's key steps
constexpr int QK_CHAIN = 4;
constexpr int MAX_SMEM = 232448;   // a block's shared-memory limit on sm_90

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

// shared-memory row strides in elements: Q and K rows are read as 8-byte
// (f32) or 4-byte (bf16) pairs at column 2t of row g, V as single elements
// at rows 2t, 2t + 1 and column g; these strides put the 32 lanes of each
// load on distinct banks (f32: Q/K stride = 8 mod 32 words, V 4 mod 32;
// at hd 112 24 and 20, which keep each half-warp's 8-byte Q / K loads and
// the warp's V loads on distinct banks too; bf16: stride / 2 = 4 mod 32
// words for Q/K at hd 64 and 128, and spread for the rest; V stride = 8
// mod 32 elements)
template <int HD, typename T>
__host__ __device__ constexpr int qk_stride() {
  return HD + 8;
}
template <int HD, typename T>
__host__ __device__ constexpr int v_stride() {
  return is_f32<T>() ? HD + 4 : HD + 8;
}

template <int HD, typename TQ, typename TKV>
constexpr size_t smem_bytes() {
  return sizeof(TQ) * BM * qk_stride<HD, TQ>() +
         sizeof(TKV) * STAGES * BK * (qk_stride<HD, TKV>() + v_stride<HD, TKV>());
}
// the general kernel: a Q slice and one K slice and V tile, HS wide
template <int HS, typename TQ, typename TKV>
constexpr size_t general_smem_bytes() {
  return sizeof(TQ) * BM * qk_stride<HS, TQ>() +
         sizeof(TKV) * BK * (qk_stride<HS, TKV>() + v_stride<HS, TKV>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (11 significant bits), nearest with ties away from
// zero: bit-identical to cvt.rna.tf32.f32 for finite x
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo exactly in f32 (|lo| <= 2^-11 |x|); the tensor core reads
// lo's top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// D += A . B, m16n8k8, TF32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive elements (columns c, c + 1 of one row) as TF32 operand
// pairs: hi (exact for bf16) and, for f32, lo.
__device__ __forceinline__ void load_pair(const float* p, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  split_tf32(x.x, hi[0], lo[0]);
  split_tf32(x.y, hi[1], lo[1]);
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, uint32_t (&hi)[2],
                                          uint32_t (&)[2]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  hi[0] = w << 16;  // the lower address holds the first element
  hi[1] = w & 0xffff0000u;
}
__device__ __forceinline__ void load_one(const float* p, uint32_t& hi, uint32_t& lo) {
  split_tf32(*p, hi, lo);
}
__device__ __forceinline__ void load_one(const __nv_bfloat16* p, uint32_t& hi, uint32_t&) {
  hi = static_cast<uint32_t>(*reinterpret_cast<const unsigned short*>(p)) << 16;
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_one(float* p, float a) { *p = a; }
__device__ __forceinline__ float elem_zero(const float*) { return 0.f; }
__device__ __forceinline__ __nv_bfloat16 elem_zero(const __nv_bfloat16*) {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// S += Q.K^T for one warp's 16 rows and a 64-key tile over KT 8-wide
// head-dim steps: Q rows at qw (stride SQ), keys at ks (stride SK); step
// kk reads columns 8kk + 2t, 8kk + 2t + 1 as logical k = t, t + 4.  Each
// chain of QC steps' passes starts from zero and lands in s by one f32 add
// ("Sums" above).
template <int KT, int SQ, int SK, typename TQ, typename TKV>
__device__ __forceinline__ void qk_tile(const TQ* qw, const TKV* ks, int g, int t,
                                        float (&s)[BK / 8][4]) {
  constexpr int NT = BK / 8;
  constexpr int QC = KT % QK_CHAIN == 0 ? QK_CHAIN : 2;  // head-dim steps per chain
  constexpr bool SPLIT_Q = is_f32<TQ>();
  constexpr bool SPLIT_KV = is_f32<TKV>();
#pragma unroll 2
  for (int k2 = 0; k2 < KT; k2 += QC) {
    uint32_t ah[QC][4], al[QC][4];
#pragma unroll
    for (int j = 0; j < QC; ++j) {
      uint32_t x[2], y[2], xl[2], yl[2];
      load_pair(qw + g * SQ + 8 * (k2 + j) + 2 * t, x, xl);
      load_pair(qw + (g + 8) * SQ + 8 * (k2 + j) + 2 * t, y, yl);
      ah[j][0] = x[0], ah[j][1] = y[0], ah[j][2] = x[1], ah[j][3] = y[1];
      al[j][0] = xl[0], al[j][1] = yl[0], al[j][2] = xl[1], al[j][3] = yl[1];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};  // QC steps' passes, small first
#pragma unroll
      for (int j = 0; j < QC; ++j) {
        uint32_t bh[2], bl[2];
        load_pair(ks + (8 * n + g) * SK + 8 * (k2 + j) + 2 * t, bh, bl);
        if constexpr (SPLIT_KV) mma_tf32(d, ah[j], bl[0], bl[1]);
        if constexpr (SPLIT_Q) mma_tf32(d, al[j], bh[0], bh[1]);
        mma_tf32(d, ah[j], bh[0], bh[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += d[e];
    }
  }
}

// Scale, mask and the online softmax of one tile's scores in registers
// (keys from k0); lane (g, t) holds keys 8n + 2t, 8n + 2t + 1 of rows g
// (e = 0, 1) and g + 8 (e = 2, 3).  Leaves P in s and rescales the KT
// output steps o.
template <int KT>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 8][4], float (&o)[KT][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const int (&q_pos)[2], int k0, int t, int kv_valid,
                                             float scale) {
  constexpr int NT = BK / 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * n + 2 * t + e;
        const bool live = key <= q_pos[i] && key < kv_valid;
        const float x = live ? s[n][2 * i + e] * scale : -CUDART_INF_F;
        s[n][2 * i + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[i], mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float corr = isfinite(m_run[i]) ? expf(m_run[i] - m_safe) : 0.f;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[n][2 * i + e] - m_safe);  // 0 where masked
        s[n][2 * i + e] = p;
        rs += p;
      }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run[i] = l_run[i] * corr + rs;
    m_run[i] = m_new;
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      o[n][2 * i] *= corr;
      o[n][2 * i + 1] *= corr;
    }
  }
}

// O += P.V over KT 8-wide output steps: key step n of S is the A operand
// (logical k = t <-> key 2t, k = t + 4 <-> key 2t + 1); V's B operand
// (rows at vs, stride SV) reads the same keys.
template <int KT, int SV, typename TKV>
__device__ __forceinline__ void pv_tile(const TKV* vs, const float (&s)[BK / 8][4], int g,
                                        int t, float (&o)[KT][4]) {
  constexpr int NT = BK / 8;
  constexpr int PC = NT;  // key steps per chain
  constexpr bool SPLIT_KV = is_f32<TKV>();
#pragma unroll
  for (int n2 = 0; n2 < NT; n2 += PC) {
    uint32_t ph[PC][4], pl[PC][4];
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      split_tf32(s[n2 + j][0], ph[j][0], pl[j][0]);
      split_tf32(s[n2 + j][2], ph[j][1], pl[j][1]);
      split_tf32(s[n2 + j][1], ph[j][2], pl[j][2]);
      split_tf32(s[n2 + j][3], ph[j][3], pl[j][3]);
    }
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < PC; ++j) {
        const TKV* v0 = vs + (8 * (n2 + j) + 2 * t) * SV + 8 * c + g;
        uint32_t bh[2], bl[2];
        load_one(v0, bh[0], bl[0]);
        load_one(v0 + SV, bh[1], bl[1]);
        mma_tf32(d, pl[j], bh[0], bh[1]);
        if constexpr (SPLIT_KV) mma_tf32(d, ph[j], bl[0], bl[1]);
        mma_tf32(d, ph[j], bh[0], bh[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] += d[e];
    }
  }
}

// The block's place in the grid: grid x lists (row tile, batch x KV head)
// with the batch x KV head fastest and the longest causal rows first.
struct BlockPlace {
  int b, hk, row0;
};
__device__ __forceinline__ BlockPlace block_place(int kvh, int n_bh) {
  const int rt = blockIdx.x / n_bh;
  const int bh = blockIdx.x - rt * n_bh;
  const int row_tiles = gridDim.x / n_bh;
  return BlockPlace{bh / kvh, bh - (bh / kvh) * kvh, (row_tiles - 1 - rt) * BM};
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_mma_kernel(const TQ* __restrict__ q,    // (B, Sq, H, HD)
                     const TKV* __restrict__ k,   // (B, Sk, KV, HD)
                     const TKV* __restrict__ v,   // (B, Sk, KV, HD)
                     TQ* __restrict__ out,        // (B, Sq, H, HD)
                     int n_heads, int sq, int sk, int kvh, int groups,
                     int q_offset, int kv_valid, float scale, int n_bh) {
  constexpr int SQ = qk_stride<HD, TQ>();
  constexpr int SK = qk_stride<HD, TKV>();
  constexpr int SV = v_stride<HD, TKV>();
  constexpr int STAGE = BK * (SK + SV);  // elements of one K + V stage
  constexpr int KT = HD / 8;             // 8-wide steps of the head dim
  constexpr int NT = BK / 8;             // 8-key steps of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);  // [BM][SQ]
  TKV* kvs = reinterpret_cast<TKV*>(smem + sizeof(TQ) * BM * SQ);  // stages of [BK][SK], [BK][SV]

  const BlockPlace bp = block_place(kvh, n_bh);
  const int b = bp.b;
  const int hk = bp.hk;
  const int n_rows = sq * groups;  // (position, head) rows
  const int row0 = bp.row0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;  // fragment row group
  const int t = tid & 3;          // thread in the group

  const size_t q_stride = static_cast<size_t>(n_heads) * HD;  // per position
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const size_t q_base = static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(hk) * groups * HD;
  const size_t kv_base = static_cast<size_t>(b) * sk * kv_stride + static_cast<size_t>(hk) * HD;

  // keys at or past k_end are masked for every row of the block, keys at or
  // past k_end_w for every row of this warp
  const int last_row = min(row0 + BM, n_rows) - 1;
  const int k_end = min(kv_valid, q_offset + last_row / groups + 1);
  const int w_row0 = row0 + 16 * warp;
  const int k_end_w =
      w_row0 < n_rows ? min(kv_valid, q_offset + min(w_row0 + 15, n_rows - 1) / groups + 1) : 0;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  // Q rows of the block (zeros past the last row)
  {
    constexpr int EPC = 16 / sizeof(TQ);  // elements per 16-byte chunk
    constexpr int CH = HD / EPC;
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH;
      const int c = i - r * CH;
      const int gr = row0 + r;
      const bool ok = gr < n_rows;
      const int pos = ok ? gr / groups : 0;
      const int j = ok ? gr - pos * groups : 0;
      cp_async16(qs + r * SQ + c * EPC,
                 q + q_base + static_cast<size_t>(pos) * q_stride + j * HD + c * EPC, ok);
    }
  }
  auto load_tile = [&](int tile, int stage) {
    constexpr int EPC = 16 / sizeof(TKV);
    constexpr int CH = HD / EPC;
    TKV* ks = kvs + stage * STAGE;
    TKV* vs = ks + BK * SK;
    const int key0 = tile * BK;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH;
      const int c = i - r * CH;
      const bool ok = key0 + r < k_end;
      const size_t off = kv_base + static_cast<size_t>(ok ? key0 + r : 0) * kv_stride + c * EPC;
      cp_async16(ks + r * SK + c * EPC, k + off, ok);
      cp_async16(vs + r * SV + c * EPC, v + off, ok);
    }
  };
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();  // Q and the first tile

  // absolute positions of this thread's rows g and g + 8; -1 past the last
  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = w_row0 + g + 8 * i;
    q_pos[i] = gr < n_rows ? q_offset + gr / groups : -1;
  }
  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  const TQ* qw = qs + 16 * warp * SQ;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();
    const int k0 = it * BK;
    if (k0 < k_end_w) {
      const TKV* ks = kvs + (it & 1) * STAGE;
      const TKV* vs = ks + BK * SK;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      qk_tile<KT, SQ, SK>(qw, ks, g, t, s);
      softmax_tile<KT>(s, o, m_run, l_run, q_pos, k0, t, kv_valid, scale);
      pv_tile<KT, SV>(vs, s, g, t, o);
    }
    __syncthreads();  // the stage read here is the next iteration's target
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = w_row0 + g + 8 * i;
    if (gr >= n_rows) continue;
    const int pos = gr / groups;
    const float den = fmaxf(l_run[i], 1e-30f);
    TQ* orow = out + q_base + static_cast<size_t>(pos) * q_stride + (gr - pos * groups) * HD;
#pragma unroll
    for (int c = 0; c < KT; ++c)
      store_pair(orow + 8 * c + 2 * t, o[c][2 * i] / den, o[c][2 * i + 1] / den);
  }
}

// The general kernel: any head dim hd, any element alignment.  The same
// rows, tiles, products, softmax and sums as above; what differs is how
// the operands arrive.  Output columns are cut into column blocks of HS on
// grid y; a block computes each tile's full scores from the head dim in
// slices of HS (the Q slice and the K slice copied element by element into
// shared memory, zero past hd: zero columns add nothing to a score), then
// the online softmax, then P.V for its own HS columns of V only (zero past
// hd, never written out).  One slice (hd <= HS) keeps the block's Q in
// shared memory across tiles; more re-copy the Q slice each tile.  No
// `cp.async`: an element copy takes any address, so odd head dims and
// views at any offset need no 16-byte alignment.  One stage, no ring: the
// path of head dims and layouts the fast kernel is not built for.
template <int HS, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_general_kernel(const TQ* __restrict__ q,    // (B, Sq, H, hd)
                         const TKV* __restrict__ k,   // (B, Sk, KV, hd)
                         const TKV* __restrict__ v,   // (B, Sk, KV, hd)
                         TQ* __restrict__ out,        // (B, Sq, H, hd)
                         int n_heads, int sq, int sk, int kvh, int groups,
                         int q_offset, int kv_valid, float scale, int n_bh, int hd) {
  constexpr int SQ = qk_stride<HS, TQ>();
  constexpr int SK = qk_stride<HS, TKV>();
  constexpr int SV = v_stride<HS, TKV>();
  constexpr int KT = HS / 8;
  constexpr int NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);                            // [BM][SQ]
  TKV* ks = reinterpret_cast<TKV*>(smem + sizeof(TQ) * BM * SQ);   // [BK][SK]
  TKV* vs = ks + BK * SK;                                          // [BK][SV]

  const BlockPlace bp = block_place(kvh, n_bh);
  const int n_rows = sq * groups;
  const int row0 = bp.row0;
  const int col0 = blockIdx.y * HS;  // this block's output columns
  const int n_slices = (hd + HS - 1) / HS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;

  const size_t q_stride = static_cast<size_t>(n_heads) * hd;
  const size_t kv_stride = static_cast<size_t>(kvh) * hd;
  const size_t q_base =
      static_cast<size_t>(bp.b) * sq * q_stride + static_cast<size_t>(bp.hk) * groups * hd;
  const size_t kv_base = static_cast<size_t>(bp.b) * sk * kv_stride + static_cast<size_t>(bp.hk) * hd;

  const int last_row = min(row0 + BM, n_rows) - 1;
  const int k_end = min(kv_valid, q_offset + last_row / groups + 1);
  const int w_row0 = row0 + 16 * warp;
  const int k_end_w =
      w_row0 < n_rows ? min(kv_valid, q_offset + min(w_row0 + 15, n_rows - 1) / groups + 1) : 0;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  auto copy_q = [&](int c0) {  // Q columns [c0, c0 + HS) of the block's rows
    for (int i = tid; i < BM * HS; i += THREADS) {
      const int r = i / HS;
      const int c = i - r * HS;
      const int gr = row0 + r;
      TQ x = elem_zero(q);
      if (gr < n_rows && c0 + c < hd) {
        const int pos = gr / groups;
        x = q[q_base + static_cast<size_t>(pos) * q_stride + (gr - pos * groups) * hd + c0 + c];
      }
      qs[r * SQ + c] = x;
    }
  };
  auto copy_kv = [&](const TKV* src, TKV* dst, int stride, int key0, int c0) {
    for (int i = tid; i < BK * HS; i += THREADS) {
      const int r = i / HS;
      const int c = i - r * HS;
      TKV x = elem_zero(src);
      if (key0 + r < k_end && c0 + c < hd)
        x = src[kv_base + static_cast<size_t>(key0 + r) * kv_stride + c0 + c];
      dst[r * stride + c] = x;
    }
  };

  int q_pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = w_row0 + g + 8 * i;
    q_pos[i] = gr < n_rows ? q_offset + gr / groups : -1;
  }
  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  const TQ* qw = qs + 16 * warp * SQ;
  if (n_slices == 1) copy_q(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int sl = 0; sl < n_slices; ++sl) {
      __syncthreads();  // the previous readers of the slices are done
      if (n_slices > 1) copy_q(sl * HS);
      copy_kv(k, ks, SK, k0, sl * HS);
      __syncthreads();
      if (k0 < k_end_w) qk_tile<KT, SQ, SK>(qw, ks, g, t, s);
    }
    copy_kv(v, vs, SV, k0, col0);
    __syncthreads();
    if (k0 < k_end_w) {
      softmax_tile<KT>(s, o, m_run, l_run, q_pos, k0, t, kv_valid, scale);
      pv_tile<KT, SV>(vs, s, g, t, o);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = w_row0 + g + 8 * i;
    if (gr >= n_rows) continue;
    const int pos = gr / groups;
    const float den = fmaxf(l_run[i], 1e-30f);
    TQ* orow = out + q_base + static_cast<size_t>(pos) * q_stride + (gr - pos * groups) * hd;
#pragma unroll
    for (int c = 0; c < KT; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * c + 2 * t + e;
        if (col < hd) store_one(orow + col, o[c][2 * i + e] / den);
      }
  }
}

// The fast kernel's instance for head dim HD, or (GENERAL) the general
// kernel's for slices of HD.
template <int HD, bool GENERAL, typename TQ, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, void* out, int b,
                 int sq, int sk, int h, int kvh, int hd, int q_offset, int kv_valid,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = GENERAL ? general_smem_bytes<HD, TQ, TKV>() : smem_bytes<HD, TQ, TKV>();
  static_assert(smem <= MAX_SMEM, "flash_attn: tiles exceed a block's shared memory");
  const long long n_bh = static_cast<long long>(b) * kvh;
  const long long row_tiles = (static_cast<long long>(sq) * (h / kvh) + BM - 1) / BM;
  if (n_bh * row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_bh * row_tiles),
                  GENERAL ? static_cast<unsigned>((hd + HD - 1) / HD) : 1u);
  const TQ* qq = static_cast<const TQ*>(q);
  const TKV* kk = static_cast<const TKV*>(k);
  const TKV* vv = static_cast<const TKV*>(v);
  TQ* oo = static_cast<TQ*>(out);
  cudaError_t e;
  if constexpr (GENERAL) {
    auto kern = flash_fwd_general_kernel<HD, TQ, TKV>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, THREADS, smem, stream>>>(qq, kk, vv, oo, h, sq, sk, kvh, h / kvh, q_offset,
                                          kv_valid, scale, static_cast<int>(n_bh), hd);
  } else {
    auto kern = flash_fwd_mma_kernel<HD, TQ, TKV>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, THREADS, smem, stream>>>(qq, kk, vv, oo, h, sq, sk, kvh, h / kvh, q_offset,
                                          kv_valid, scale, static_cast<int>(n_bh));
  }
  return static_cast<int>(cudaGetLastError());
}

// registers, local (spill) bytes per thread, dynamic shared memory bytes
template <int HD, bool GENERAL, typename TQ, typename TKV>
int attributes_typed(int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if constexpr (GENERAL) e = cudaFuncGetAttributes(&a, flash_fwd_general_kernel<HD, TQ, TKV>);
  else e = cudaFuncGetAttributes(&a, flash_fwd_mma_kernel<HD, TQ, TKV>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(GENERAL ? general_smem_bytes<HD, TQ, TKV>() : smem_bytes<HD, TQ, TKV>());
  return 0;
}

template <typename F>
int dispatch_types(int q_is_bf16, int kv_is_bf16, F&& f) {
  using bf = __nv_bfloat16;
  if (q_is_bf16 && kv_is_bf16) return f(static_cast<bf*>(nullptr), static_cast<bf*>(nullptr));
  if (q_is_bf16) return f(static_cast<bf*>(nullptr), static_cast<float*>(nullptr));
  if (kv_is_bf16) return f(static_cast<float*>(nullptr), static_cast<bf*>(nullptr));
  return f(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
}

// The fast kernel's head dims (GENERAL false), or the general kernel's
// slice width for head dim hd (64 for hd <= 64, else 128); f is called
// with the head dim and GENERAL as integral constants.
template <typename F>
int dispatch_hd(int hd, bool general, F&& f) {
  using std::integral_constant;
  using no = std::false_type;
  if (general) {
    if (hd <= 0) return static_cast<int>(cudaErrorInvalidValue);
    return hd <= 64 ? f(integral_constant<int, 64>(), std::true_type())
                    : f(integral_constant<int, 128>(), std::true_type());
  }
  switch (hd) {
    case 16: return f(integral_constant<int, 16>(), no());
    case 32: return f(integral_constant<int, 32>(), no());
    case 64: return f(integral_constant<int, 64>(), no());
    case 96: return f(integral_constant<int, 96>(), no());
    case 112: return f(integral_constant<int, 112>(), no());
    case 128: return f(integral_constant<int, 128>(), no());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// general nonzero: the general kernel (any head dim, any alignment), else
// the fast kernel of head dim hd (16, 32, 64, 96, 112 or 128; q, k, v 16-byte
// aligned: `flash_attn.kernel_variant` picks).  Returns cudaGetLastError()
// after the launch (0 = launched); a head dim without a fast kernel returns
// cudaErrorInvalidValue.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int sk, int h,
                                 int kvh, int hd, int q_offset, int kv_valid,
                                 int q_is_bf16, int kv_is_bf16, float scale,
                                 int general, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch_hd(hd, general != 0, [&](auto hdc, auto gen) {
    constexpr int HD = decltype(hdc)::value;
    constexpr bool GENERAL = decltype(gen)::value;
    return dispatch_types(q_is_bf16, kv_is_bf16, [&](auto* tq, auto* tkv) {
      using TQ = std::remove_pointer_t<decltype(tq)>;
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      return launch_typed<HD, GENERAL, TQ, TKV>(q, k, v, out, b, sq, sk, h, kvh, hd, q_offset,
                                                kv_valid, scale, s);
    });
  });
}

// The kernel instance's registers, spill (local) bytes per thread and
// dynamic shared memory bytes, written to out[0..2]; returns a cudaError_t.
extern "C" int flash_attn_attributes(int hd, int q_is_bf16, int kv_is_bf16, int general,
                                     int* out) {
  return dispatch_hd(hd, general != 0, [&](auto hdc, auto gen) {
    constexpr int HD = decltype(hdc)::value;
    constexpr bool GENERAL = decltype(gen)::value;
    return dispatch_types(q_is_bf16, kv_is_bf16, [&](auto* tq, auto* tkv) {
      using TQ = std::remove_pointer_t<decltype(tq)>;
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      return attributes_typed<HD, GENERAL, TQ, TKV>(out);
    });
  });
}
