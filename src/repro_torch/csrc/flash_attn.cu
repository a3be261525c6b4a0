// Kernel B10: causal GQA flash-attention forward, online softmax in f32.
//
// Replaces: src/repro/kernels/flash_attn.py `flash_attention_fwd`
//           (Pallas body `_flash_fwd_kernel`), the prefill path of
//           src/repro/models/layers.py `gqa_attention`.
//
// What it computes, per query head h (KV head h / (H / KV)) and query row
// i at absolute position q_offset + i: q is widened to f32 and scaled
// (scale applied to q before the dot, as the reference does), key j is
// live iff j <= q_offset + i and j < kv_valid, and the row's output is
// sum_j softmax(q.k_j) v_j by an online softmax over key tiles: running
// max m (with the reference's -inf guard: m_safe = 0 while m is -inf),
// running sum l, f32 accumulator, out = acc / max(l, 1e-30) in q's dtype.
// A row that never sees a live key gives 0.  q may be bf16 or f32, k / v
// bf16 or f32 independently (the serving path reads a bf16 q against an
// f32 cache).
//
// What bounds it on an H100: operations.  At the qwen3-8b prefill shape
// (B 4, S 2048, H 32, KV 8, hd 128) the causal pairs need 2 * B * H * hd *
// 2,098,176 = 68.7 G f32 FMAs (2.05 ms at 33.5 T FMA/s) against ~0.2 GB
// of Q, O and K/V (0.06 ms at 3.35 TB/s).  The reference widens bf16 to
// f32 and accumulates in f32, so this kernel multiplies in f32 on the CUDA
// cores; tensor cores (wgmma, TF32 or bf16-rounded K/V) are later work.
//
// Design.  On the TPU the KV axis is the innermost sequential grid axis,
// carrying m, l and acc in VMEM scratch.  Here it is a loop inside the
// block: one block per (batch, head, 64-row query tile), launched longest
// causal rows first.  The block keeps its scaled Q tile (transposed) in
// shared memory, streams 64-key K (transposed) and V tiles through shared
// memory, and keeps m, l and acc in registers: 256 threads as 16 x 16,
// thread (ty, tx) owns query rows 4ty..4ty+3, scores against keys
// 4tx..4tx+3 of the tile, and output columns 4tx..4tx+3 of each 64-wide
// chunk of the head.  Row max and row sum reduce over the 16 lanes that
// share a row (shuffles); probabilities go through shared memory to the
// P.V product.  Key tiles past min(kv_valid, q_offset + last row + 1) are
// not visited: this is the reference's `any_live` skip, on the kernel's
// own tiles.  The Pallas blocks `bq` / `bk` (VMEM sizes) do not apply
// here: the wrapper checks them as the reference does and the plain
// version (kernels/flash_attn.py) honours them; the kernel ignores them.
// Exponentials are expf (not __expf); the final division is a division.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // 16 x 16

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (HD * BQ + HD * BK + BK * HD + BK * BQ);
}

template <int HD, typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const TQ* __restrict__ q,    // (B, Sq, H, HD)
                 const TKV* __restrict__ k,   // (B, Sk, KV, HD)
                 const TKV* __restrict__ v,   // (B, Sk, KV, HD)
                 TQ* __restrict__ out,        // (B, Sq, H, HD)
                 int n_heads, int sq, int sk, int kvh, int groups,
                 int q_offset, int kv_valid, float scale) {
  constexpr int NCH = (HD + 63) / 64;  // 64-wide output column chunks
  constexpr int D4 = HD / 4;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [HD][BQ] scaled q
  float* kT = qT + HD * BQ;                      // [HD][BK]
  float* vs = kT + HD * BK;                      // [BK][HD]
  float* ps = vs + BK * HD;                      // [BK][BQ] probabilities

  const int b = blockIdx.x / n_heads;
  const int h = blockIdx.x - b * n_heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const size_t q_stride = static_cast<size_t>(n_heads) * HD;  // per position
  const size_t kv_stride = static_cast<size_t>(kvh) * HD;
  const TQ* qb = q + static_cast<size_t>(b) * sq * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_off =
      static_cast<size_t>(b) * sk * kv_stride + static_cast<size_t>(h / groups) * HD;
  const TKV* kb = k + kv_off;
  const TKV* vb = v + kv_off;

  // Q tile, widened, scaled and transposed; rows past Sq are zeros
  for (int i = tid; i < BQ * D4; i += THREADS) {
    const int r = i % BQ;
    const int d = 4 * (i / BQ);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < sq) x = load4(qb + static_cast<size_t>(q0 + r) * q_stride + d);
    qT[(d + 0) * BQ + r] = x.x * scale;
    qT[(d + 1) * BQ + r] = x.y * scale;
    qT[(d + 2) * BQ + r] = x.z * scale;
    qT[(d + 3) * BQ + r] = x.w * scale;
  }

  float m_run[4], l_run[4], acc[4][NCH][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -CUDART_INF_F;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // keys at or past k_end are masked for every row of the tile
  const int k_end = min(kv_valid, q_offset + min(q0 + BQ, sq));
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BK * D4; i += THREADS) {
      const int c = i % BK;
      const int d = 4 * (i / BK);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < sk) x = load4(kb + static_cast<size_t>(k0 + c) * kv_stride + d);
      kT[(d + 0) * BK + c] = x.x;
      kT[(d + 1) * BK + c] = x.y;
      kT[(d + 2) * BK + c] = x.z;
      kT[(d + 3) * BK + c] = x.w;
    }
    for (int i = tid; i < BK * D4; i += THREADS) {
      const int c = i / D4;
      const int d = 4 * (i - c * D4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + c < sk) x = load4(vb + static_cast<size_t>(k0 + c) * kv_stride + d);
      store4(vs + c * HD + d, x);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = load4(qT + d * BQ + 4 * ty);
      const float4 c = load4(kT + d * BK + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_offset + q0 + 4 * ty + i;
      bool live[4];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + 4 * tx + j;
        live[j] = k_pos <= q_pos && k_pos < kv_valid;
        s[i][j] = live[j] ? s[i][j] : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_run[i], row_reduce_max(mx));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float corr = isfinite(m_run[i]) ? expf(m_run[i] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_safe) : 0.f;
        rs += s[i][j];
      }
      l_run[i] = l_run[i] * corr + row_reduce_sum(rs);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store4(ps + (4 * tx + j) * BQ + 4 * ty,
             make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float4 p = load4(ps + c * BQ + 4 * ty);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int col = 64 * ch + 4 * tx;
        if (HD % 64 == 0 || col < HD) {
          const float4 x = load4(vs + c * HD + col);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][ch][0] = fmaf(pv[i], x.x, acc[i][ch][0]);
            acc[i][ch][1] = fmaf(pv[i], x.y, acc[i][ch][1]);
            acc[i][ch][2] = fmaf(pv[i], x.z, acc[i][ch][2]);
            acc[i][ch][3] = fmaf(pv[i], x.w, acc[i][ch][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * ty + i;
    if (r >= sq) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    TQ* orow = out + (static_cast<size_t>(b) * sq + r) * q_stride + static_cast<size_t>(h) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int col = 64 * ch + 4 * tx;
      if (HD % 64 == 0 || col < HD)
        store4(orow + col, make_float4(acc[i][ch][0] / den, acc[i][ch][1] / den,
                                       acc[i][ch][2] / den, acc[i][ch][3] / den));
    }
  }
}

template <int HD, typename TQ, typename TKV>
int launch_typed(const void* q, const void* k, const void* v, void* out, int b,
                 int sq, int sk, int h, int kvh, int q_offset, int kv_valid,
                 float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<HD, TQ, TKV>;
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(out), h, sq, sk, kvh, h / kvh,
      q_offset, kv_valid, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b, int sq,
              int sk, int h, int kvh, int q_offset, int kv_valid, int q_is_bf16,
              int kv_is_bf16, float scale, cudaStream_t s) {
  using bf = __nv_bfloat16;
  if (q_is_bf16 && kv_is_bf16)
    return launch_typed<HD, bf, bf>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, scale, s);
  if (q_is_bf16)
    return launch_typed<HD, bf, float>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, scale, s);
  if (kv_is_bf16)
    return launch_typed<HD, float, bf>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, scale, s);
  return launch_typed<HD, float, float>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, scale, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched); an unsupported
// head dim returns cudaErrorInvalidValue (the wrapper refuses it first).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int b, int sq, int sk, int h,
                                 int kvh, int hd, int q_offset, int kv_valid,
                                 int q_is_bf16, int kv_is_bf16, float scale,
                                 void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch_hd<16>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, s);
    case 32:
      return launch_hd<32>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, s);
    case 64:
      return launch_hd<64>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, s);
    case 96:
      return launch_hd<96>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, s);
    case 128:
      return launch_hd<128>(q, k, v, out, b, sq, sk, h, kvh, q_offset, kv_valid, q_is_bf16, kv_is_bf16, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
