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
// (flash_attn.cuh; kernels/flash_attn.py `kernel_variant`): the same
// products, chains, softmax and sums through the same helpers, in row tiles
// of 16 rows split between 1, 2, 4 or 8 warps by head-dim columns, so each
// score is computed once and the accumulator stays at most 64 registers a
// lane; the head dim padded to the instance's width (48, 64, 80 or 128
// columns a warp, `general_shape`); rows 16-byte aligned arrive by
// `cp.async` in the fast kernel's two-stage ring ("staged"), others element
// by element ("general").  Its sums differ from the fast kernel's in one
// place: past one warp a row tile, a score is the sum of the warps'
// partial scores over their column ranges, each a chain of the fast
// kernel's kind, added warp 0 first.  The error argument above holds term
// by term, so it keeps the same bound.  There is no CUDA-core body.

#include "flash_attn.cuh"

namespace {

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

// The fast kernel's instance for head dim HD.
template <int HD, typename TQ, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, void* out, int b,
                 int sq, int sk, int h, int kvh, int q_offset, int kv_valid,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD, TQ, TKV>();
  static_assert(smem <= MAX_SMEM, "flash_attn: tiles exceed a block's shared memory");
  const long long n_bh = static_cast<long long>(b) * kvh;
  const long long row_tiles = (static_cast<long long>(sq) * (h / kvh) + BM - 1) / BM;
  if (n_bh * row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kern = flash_fwd_mma_kernel<HD, TQ, TKV>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<static_cast<unsigned>(n_bh * row_tiles), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), h, sq, sk, kvh, h / kvh, q_offset, kv_valid, scale,
      static_cast<int>(n_bh));
  return static_cast<int>(cudaGetLastError());
}

// registers, local (spill) bytes per thread, dynamic shared memory bytes
template <int HD, typename TQ, typename TKV>
int attributes_typed(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, flash_fwd_mma_kernel<HD, TQ, TKV>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem_bytes<HD, TQ, TKV>());
  return 0;
}

// The fast kernel's head dims; f is called with the head dim as an
// integral constant.
template <typename F>
int dispatch_hd(int hd, F&& f) {
  using std::integral_constant;
  switch (hd) {
    case 16: return f(integral_constant<int, 16>());
    case 32: return f(integral_constant<int, 32>());
    case 64: return f(integral_constant<int, 64>());
    case 96: return f(integral_constant<int, 96>());
    case 112: return f(integral_constant<int, 112>());
    case 128: return f(integral_constant<int, 128>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// variant 0: the fast kernel; 1: the general kernel, staged (rows of q, k,
// v, out 16-byte aligned, hd <= 1024); 2: the general kernel, element
// copies.  With `attrs`, describe the instance instead of launching.
int flash_any(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
              int h, int kvh, int hd, int q_offset, int kv_valid, int q_is_bf16, int kv_is_bf16,
              float scale, int variant, cudaStream_t stream, int* attrs) {
  if (variant == 0) {
    return dispatch_hd(hd, [&](auto hdc) {
      constexpr int HD = decltype(hdc)::value;
      return dispatch_types(q_is_bf16, kv_is_bf16, [&](auto* tq, auto* tkv) {
        using TQ = std::remove_pointer_t<decltype(tq)>;
        using TKV = std::remove_pointer_t<decltype(tkv)>;
        return attrs != nullptr
                   ? attributes_typed<HD, TQ, TKV>(attrs)
                   : launch_typed<HD, TQ, TKV>(q, k, v, out, b, sq, sk, h, kvh, q_offset,
                                               kv_valid, scale, stream);
      });
    });
  }
  const bool elem = variant == 2;
  const GeneralShape gs = general_shape(hd, elem);
  auto part = !elem && gs.wpr == 1 ? repro_flash::general_part0 : repro_flash::general_part1;
  return part(q, k, v, out, b, sq, sk, h, kvh, hd, q_offset, kv_valid, q_is_bf16, kv_is_bf16,
              scale, elem, stream, attrs);
}

}  // namespace

// `variant` 0: the fast kernel of head dim hd (16, 32, 64, 96, 112 or 128;
// q, k, v 16-byte aligned); 1: the general kernel staged (every row of q,
// k, v, out 16-byte aligned, hd <= 1024); 2: the general kernel with
// element copies (any hd and offset).  `flash_attn.kernel_variant` picks.
// Returns cudaGetLastError() after the launch (0 = launched); an instance
// the variant does not have returns cudaErrorInvalidValue.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int sk, int h,
                                 int kvh, int hd, int q_offset, int kv_valid,
                                 int q_is_bf16, int kv_is_bf16, float scale,
                                 int variant, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  return flash_any(q, k, v, out, b, sq, sk, h, kvh, hd, q_offset, kv_valid, q_is_bf16,
                   kv_is_bf16, scale, variant, static_cast<cudaStream_t>(stream), nullptr);
}

// The instance's registers, spill (local) bytes per thread and dynamic
// shared memory bytes, written to out[0..2]; returns a cudaError_t.
extern "C" int flash_attn_attributes(int hd, int q_is_bf16, int kv_is_bf16, int variant,
                                     int* out) {
  return flash_any(nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, 1, hd, 0, 0, q_is_bf16,
                   kv_is_bf16, 1.f, variant, nullptr, out);
}
