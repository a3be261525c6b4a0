// Device code of kernel B10 (causal GQA flash-attention forward, split
// TF32 on the tensor cores) shared by its sources: flash_attn.cu (the fast
// kernel and the C interface; its note sets out the design, the error
// argument and the sums), flash_attn_general.cu and
// flash_attn_general_wide.cu (the general kernel's instances, in two parts
// that compile in parallel).

#pragma once

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
// before one f32 add into the scores (see "Sums" in flash_attn.cu); P.V chains a
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

// S += Q.K^T for one warp's 16 rows and a tile of 8 * NT keys (64 in the
// fast kernel) over KT 8-wide head-dim steps: Q rows at qw (stride SQ),
// keys at ks (stride SK); step kk reads columns 8kk + 2t, 8kk + 2t + 1 as
// logical k = t, t + 4.  Each chain of QC steps' passes starts from zero
// and lands in s by one f32 add ("Sums" in flash_attn.cu).
template <int KT, int SQ, int SK, typename TQ, typename TKV, int NT>
__device__ __forceinline__ void qk_tile(const TQ* qw, const TKV* ks, int g, int t,
                                        float (&s)[NT][4]) {
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
template <int KT, int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&o)[KT][4],
                                             float (&m_run)[2], float (&l_run)[2],
                                             const int (&q_pos)[2], int k0, int t, int kv_valid,
                                             float scale) {
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
template <int KT, int SV, typename TKV, int NT>
__device__ __forceinline__ void pv_tile(const TKV* vs, const float (&s)[NT][4], int g,
                                        int t, float (&o)[KT][4]) {
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

// The block's place in the grid: grid x lists (row tile of bm rows, batch
// x KV head) with the batch x KV head fastest and the longest causal rows
// first.
struct BlockPlace {
  int b, hk, row0;
};
__device__ __forceinline__ BlockPlace block_place(int kvh, int n_bh, int bm = BM) {
  const int rt = blockIdx.x / n_bh;
  const int bh = blockIdx.x - rt * n_bh;
  const int row_tiles = gridDim.x / n_bh;
  return BlockPlace{bh / kvh, bh - (bh / kvh) * kvh, (row_tiles - 1 - rt) * bm};
}


// bar.sync on barrier `id` (1..15; 0 is __syncthreads) for n threads
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The general kernel's layout for CW head-dim columns a warp, WPR warps a
// row tile and BKT keys a tile: WARPS / WPR row tiles of 16 rows a block,
// the head dim padded to HSP = CW * WPR (zero columns add nothing to a
// score and are never written out), two K / V stages, and past one warp a
// row tile the warps' partial scores (16 x BKT f32 each) in shared memory.
template <int CW, int WPR, int BKT, typename TQ, typename TKV>
struct GeneralLayout {
  static constexpr int RT = WARPS / WPR;
  static constexpr int BMG = 16 * RT;
  static constexpr int HSP = CW * WPR;
  static constexpr int SQ = qk_stride<HSP, TQ>();
  static constexpr int SK = qk_stride<HSP, TKV>();
  static constexpr int SV = v_stride<HSP, TKV>();
  static constexpr size_t Q_BYTES = sizeof(TQ) * BMG * SQ;
  static constexpr int STAGE = BKT * (SK + SV);  // elements of one K + V stage
  static constexpr size_t KV_BYTES = sizeof(TKV) * STAGES * STAGE;
  static constexpr size_t X_BYTES = WPR > 1 ? sizeof(float) * WARPS * 16 * BKT : 0;
  static constexpr size_t SMEM = Q_BYTES + KV_BYTES + X_BYTES;
};

// Keys a tile as the warps a row tile grow (the K / V stages stay in
// shared memory as the padded head dim grows): 64, 32, 16, 8.
__host__ __device__ constexpr int general_bk(int wpr) { return 64 / wpr; }

// The general kernel: any head dim hd.  The same rows, products, chains,
// softmax and sums as the fast kernel, in row tiles of 16 rows; what
// differs is the head dim's layout and how the operands arrive.
//   * Columns: the head dim, padded to HSP = CW * WPR, is split between
//     the WPR warps of a row tile, CW columns each (CW a multiple of 16;
//     the instantiated widths round hd up, `general_shape`).  Each warp
//     forms the partial scores of its columns (Q.K^T over them, the fast
//     kernel's chains), the partials meet in shared memory, and every warp
//     of the row tile adds them in the same order (warp 0's first, from
//     0.0), so all hold the same scores, bit for bit: each score is
//     computed once.  Each warp then runs the same online softmax and P.V
//     into its own CW output columns, so the accumulator stays at CW / 2
//     registers a lane (64 at CW 128) whatever hd.
//   * Staged (ELEM false; rows of q, k, v, out 16-byte aligned,
//     `flash_attn.kernel_variant` "staged"): Q stays in shared memory for
//     the block's life; K and V tiles arrive by 16-byte `cp.async` into a
//     two-stage ring, the next tile loading while this one computes, as
//     the fast kernel's.
//   * Element copies (ELEM; any offset, "general"): operands are copied
//     element by element into one stage, zero past hd.  Past HSP columns
//     (hd > 1024) the head dim is walked in slices of HSP (Q and K slices
//     copied again each tile, the partial scores accumulated over them)
//     and the output columns are cut into blocks of HSP on grid y.
template <int CW, int WPR, bool ELEM, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_general_kernel(const TQ* __restrict__ q,    // (B, Sq, H, hd)
                         const TKV* __restrict__ k,   // (B, Sk, KV, hd)
                         const TKV* __restrict__ v,   // (B, Sk, KV, hd)
                         TQ* __restrict__ out,        // (B, Sq, H, hd)
                         int n_heads, int sq, int sk, int kvh, int groups,
                         int q_offset, int kv_valid, float scale, int n_bh, int hd) {
  constexpr int BKT = general_bk(WPR);
  using L = GeneralLayout<CW, WPR, BKT, TQ, TKV>;
  constexpr int HSP = L::HSP, SQ = L::SQ, SK = L::SK, SV = L::SV, STAGE = L::STAGE;
  constexpr int KT = CW / 8;    // 8-wide head-dim steps of a warp
  constexpr int NT = BKT / 8;   // 8-key steps of a tile
  extern __shared__ __align__(16) unsigned char smem[];
  TQ* qs = reinterpret_cast<TQ*>(smem);                            // [BMG][SQ]
  TKV* kvs = reinterpret_cast<TKV*>(smem + L::Q_BYTES);            // stages of [BKT][SK], [BKT][SV]
  float* xs = reinterpret_cast<float*>(smem + L::Q_BYTES + L::KV_BYTES);  // [WARPS][16 * BKT]

  const BlockPlace bp = block_place(kvh, n_bh, L::BMG);
  const int n_rows = sq * groups;
  const int row0 = bp.row0;
  const int col0 = blockIdx.y * HSP;  // output columns of the block (ELEM past HSP)
  const int n_slices = ELEM ? (hd + HSP - 1) / HSP : 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = tid & 3;
  const int rt = warp / WPR;          // row tile
  const int cw0 = (warp - rt * WPR) * CW;  // the warp's columns in the slice

  const size_t q_stride = static_cast<size_t>(n_heads) * hd;
  const size_t kv_stride = static_cast<size_t>(kvh) * hd;
  const size_t q_base =
      static_cast<size_t>(bp.b) * sq * q_stride + static_cast<size_t>(bp.hk) * groups * hd;
  const size_t kv_base = static_cast<size_t>(bp.b) * sk * kv_stride + static_cast<size_t>(bp.hk) * hd;

  const int last_row = min(row0 + L::BMG, n_rows) - 1;
  const int k_end = min(kv_valid, q_offset + last_row / groups + 1);
  const int w_row0 = row0 + 16 * rt;
  const int k_end_w =
      w_row0 < n_rows ? min(kv_valid, q_offset + min(w_row0 + 15, n_rows - 1) / groups + 1) : 0;
  const int n_tiles = k_end > 0 ? (k_end + BKT - 1) / BKT : 0;

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
  const TQ* qw = qs + 16 * rt * SQ + cw0;

  // the partial scores of the row tile's warps added in warp order, then
  // the online softmax and this warp's columns of P.V
  auto finish_tile = [&](float (&s)[NT][4], const TKV* vs, int k0) {
    if constexpr (WPR > 1) {
      float* mine = xs + warp * 16 * BKT;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
      named_barrier(1 + rt, 32 * WPR);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int c = 0; c < WPR; ++c) {
        const float* part = xs + (rt * WPR + c) * 16 * BKT;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] += part[(n * 4 + e) * 32 + lane];
      }
    }
    softmax_tile<KT>(s, o, m_run, l_run, q_pos, k0, t, kv_valid, scale);
    pv_tile<KT, SV>(vs + cw0, s, g, t, o);
  };

  if constexpr (!ELEM) {
    // zero columns hd .. HSP of Q and of both stages once: no copy writes them
    const int pad = HSP - hd;
    for (int i = tid; i < L::BMG * pad; i += THREADS) {
      const int r = i / pad;
      qs[r * SQ + hd + (i - r * pad)] = elem_zero(q);
    }
    for (int i = tid; i < STAGES * BKT * pad; i += THREADS) {
      const int r = i / pad;  // stage * BKT + key
      const int c = hd + (i - r * pad);
      TKV* st = kvs + (r / BKT) * STAGE;
      st[(r % BKT) * SK + c] = elem_zero(k);
      st[BKT * SK + (r % BKT) * SV + c] = elem_zero(v);
    }
    {
      constexpr int EPC = 16 / sizeof(TQ);  // elements per 16-byte chunk
      const int ch = hd / EPC;
      for (int i = tid; i < L::BMG * ch; i += THREADS) {
        const int r = i / ch;
        const int c = i - r * ch;
        const int gr = row0 + r;
        const bool ok = gr < n_rows;
        const int pos = ok ? gr / groups : 0;
        const int j = ok ? gr - pos * groups : 0;
        cp_async16(qs + r * SQ + c * EPC,
                   q + q_base + static_cast<size_t>(pos) * q_stride + j * hd + c * EPC, ok);
      }
    }
    auto load_tile = [&](int tile, int stage) {
      constexpr int EPC = 16 / sizeof(TKV);
      const int ch = hd / EPC;
      TKV* ks = kvs + stage * STAGE;
      TKV* vs = ks + BKT * SK;
      const int key0 = tile * BKT;
      for (int i = tid; i < BKT * ch; i += THREADS) {
        const int r = i / ch;
        const int c = i - r * ch;
        const bool ok = key0 + r < k_end;
        const size_t off = kv_base + static_cast<size_t>(ok ? key0 + r : 0) * kv_stride + c * EPC;
        cp_async16(ks + r * SK + c * EPC, k + off, ok);
        cp_async16(vs + r * SV + c * EPC, v + off, ok);
      }
    };
    if (n_tiles > 0) load_tile(0, 0);
    cp_async_commit();  // Q and the first tile
    for (int it = 0; it < n_tiles; ++it) {
      if (it + 1 < n_tiles) load_tile(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // everything but the tile just issued has landed
      __syncthreads();
      const int k0 = it * BKT;
      if (k0 < k_end_w) {
        const TKV* ks = kvs + (it & 1) * STAGE;
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
        qk_tile<KT, SQ, SK>(qw, ks + cw0, g, t, s);
        finish_tile(s, ks + BKT * SK, k0);
      }
      __syncthreads();  // the stage read here is the next iteration's target
    }
    cp_async_wait<0>();
  } else {
    TKV* ks = kvs;
    TKV* vs = kvs + BKT * SK;
    auto copy_q = [&](int c0) {  // Q columns [c0, c0 + HSP) of the block's rows
      for (int i = tid; i < L::BMG * HSP; i += THREADS) {
        const int r = i / HSP;
        const int c = i - r * HSP;
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
      for (int i = tid; i < BKT * HSP; i += THREADS) {
        const int r = i / HSP;
        const int c = i - r * HSP;
        TKV x = elem_zero(src);
        if (key0 + r < k_end && c0 + c < hd)
          x = src[kv_base + static_cast<size_t>(key0 + r) * kv_stride + c0 + c];
        dst[r * stride + c] = x;
      }
    };
    if (n_slices == 1) copy_q(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * BKT;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      for (int sl = 0; sl < n_slices; ++sl) {
        __syncthreads();  // the previous readers of the slices are done
        if (n_slices > 1) copy_q(sl * HSP);
        copy_kv(k, ks, SK, k0, sl * HSP);
        if (sl == n_slices - 1) copy_kv(v, vs, SV, k0, col0);
        __syncthreads();
        if (k0 < k_end_w) qk_tile<KT, SQ, SK>(qw, ks + cw0, g, t, s);
      }
      if (k0 < k_end_w) finish_tile(s, vs, k0);
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
    for (int c = 0; c < KT; ++c) {
      const int col = col0 + cw0 + 8 * c + 2 * t;
      if constexpr (ELEM) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < hd) store_one(orow + col + e, o[c][2 * i + e] / den);
      } else if (col < hd) {  // hd is even here: the pair lies inside the row
        store_pair(orow + col, o[c][2 * i] / den, o[c][2 * i + 1] / den);
      }
    }
  }
}

// The general kernel's instance for head dim hd: WPR warps a row tile of
// CW columns each, ELEM for element copies.  Staged: one warp a row tile
// up to hd 128 (CW = hd rounded up to 48, 64, 80 or 128), two up to 256,
// four up to 512 and eight up to 1024 (CW 128); element copies: one, two
// or eight warps of 128 (slices of 1024 past 1024).  The widths are those
// the smoke's shapes and the registry need; others round up to them, so
// the build stays short.  Mirrored by kernels/flash_attn.py
// `general_shape`.
struct GeneralShape {
  int wpr, cw;
};
inline GeneralShape general_shape(int hd, bool elem) {
  if (hd > 128) return {hd <= 256 ? 2 : (hd <= 512 && !elem ? 4 : 8), 128};
  if (elem) return {1, 128};
  return {1, hd <= 48 ? 48 : (hd <= 64 ? 64 : (hd <= 80 ? 80 : 128))};
}

// Call f(CW, WPR, ELEM) (integral constants) for the instance of
// `general_shape(hd, elem)` among those of source part PART (0: one warp a
// row tile, staged; 1: the rest), or return cudaErrorInvalidValue.
template <int PART, typename F>
int dispatch_general(int hd, bool elem, F&& f) {
  using std::integral_constant;
  using c1 = integral_constant<int, 1>;
  using c128 = integral_constant<int, 128>;
  const GeneralShape gs = general_shape(hd, elem);
  if (hd <= 0 || (!elem && hd > 1024)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (PART == 0) {
    if (!elem && gs.wpr == 1) {
      switch (gs.cw) {
        case 48: return f(integral_constant<int, 48>(), c1(), std::false_type());
        case 64: return f(integral_constant<int, 64>(), c1(), std::false_type());
        case 80: return f(integral_constant<int, 80>(), c1(), std::false_type());
        case 128: return f(c128(), c1(), std::false_type());
        default: break;
      }
    }
  } else {
    using c2 = integral_constant<int, 2>;
    using c8 = integral_constant<int, 8>;
    if (elem) {
      if (gs.wpr == 1) return f(c128(), c1(), std::true_type());
      return gs.wpr == 2 ? f(c128(), c2(), std::true_type()) : f(c128(), c8(), std::true_type());
    }
    if (gs.wpr == 2) return f(c128(), c2(), std::false_type());
    if (gs.wpr == 4) return f(c128(), integral_constant<int, 4>(), std::false_type());
    if (gs.wpr == 8) return f(c128(), c8(), std::false_type());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int dispatch_types(int q_is_bf16, int kv_is_bf16, F&& f) {
  using bf = __nv_bfloat16;
  if (q_is_bf16 && kv_is_bf16) return f(static_cast<bf*>(nullptr), static_cast<bf*>(nullptr));
  if (q_is_bf16) return f(static_cast<bf*>(nullptr), static_cast<float*>(nullptr));
  if (kv_is_bf16) return f(static_cast<float*>(nullptr), static_cast<bf*>(nullptr));
  return f(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
}

// Launch (or, with `attrs`, describe: registers, spill bytes, shared
// memory) the general instance of part PART for head dim hd.
template <int PART>
int general_part(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
                 int h, int kvh, int hd, int q_offset, int kv_valid, int q_is_bf16,
                 int kv_is_bf16, float scale, bool elem, cudaStream_t stream, int* attrs) {
  return dispatch_general<PART>(hd, elem, [&](auto cwc, auto wprc, auto elemc) {
    constexpr int CW = decltype(cwc)::value;
    constexpr int WPR = decltype(wprc)::value;
    constexpr bool ELEM = decltype(elemc)::value;
    return dispatch_types(q_is_bf16, kv_is_bf16, [&](auto* tq, auto* tkv) {
      using TQ = std::remove_pointer_t<decltype(tq)>;
      using TKV = std::remove_pointer_t<decltype(tkv)>;
      using L = GeneralLayout<CW, WPR, general_bk(WPR), TQ, TKV>;
      static_assert(L::SMEM <= MAX_SMEM, "flash_attn: tiles exceed a block's shared memory");
      auto kern = flash_fwd_general_kernel<CW, WPR, ELEM, TQ, TKV>;
      cudaError_t e;
      if (attrs != nullptr) {
        cudaFuncAttributes fa;
        e = cudaFuncGetAttributes(&fa, kern);
        if (e != cudaSuccess) return static_cast<int>(e);
        attrs[0] = fa.numRegs;
        attrs[1] = static_cast<int>(fa.localSizeBytes);
        attrs[2] = static_cast<int>(L::SMEM);
        return 0;
      }
      const long long n_bh = static_cast<long long>(b) * kvh;
      const long long row_tiles = (static_cast<long long>(sq) * (h / kvh) + L::BMG - 1) / L::BMG;
      if (n_bh * row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
      const dim3 grid(static_cast<unsigned>(n_bh * row_tiles),
                      ELEM ? static_cast<unsigned>((hd + L::HSP - 1) / L::HSP) : 1u);
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::SMEM));
      if (e != cudaSuccess) return static_cast<int>(e);
      kern<<<grid, THREADS, L::SMEM, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
          static_cast<TQ*>(out), h, sq, sk, kvh, h / kvh, q_offset, kv_valid, scale,
          static_cast<int>(n_bh), hd);
      return static_cast<int>(cudaGetLastError());
    });
  });
}

}  // namespace

namespace repro_flash {

// The general kernel's two source parts (flash_attn_general.cu: one warp a
// row tile, staged; flash_attn_general_wide.cu: the rest): `general_part`.
int general_part0(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
                  int h, int kvh, int hd, int q_offset, int kv_valid, int q_is_bf16,
                  int kv_is_bf16, float scale, bool elem, cudaStream_t stream, int* attrs);
int general_part1(const void* q, const void* k, const void* v, void* out, int b, int sq, int sk,
                  int h, int kvh, int hd, int q_offset, int kv_valid, int q_is_bf16,
                  int kv_is_bf16, float scale, bool elem, cudaStream_t stream, int* attrs);

}  // namespace repro_flash
