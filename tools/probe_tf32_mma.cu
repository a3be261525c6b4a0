// How the H100's TF32 tensor-core instruction sums: mma.sync m16n8k8
// (TF32 operands, f32 accumulator) on operands exact in TF32, against the
// exact sum in double.  Kernel B10 (src/repro_torch/csrc/flash_attn.cu)
// multiplies on this instruction, so its error budget rests on what this
// prints.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/probe_tf32_mma \
//       tools/probe_tf32_mma.cu && build/probe_tf32_mma
//
// Cases (each over many random 16x8x8 products, one warp per product):
//   same:   |a|, |b| in [1, 2), random signs, C = 0;
//   spread: one product 2^e times the others (e = 4, 8, 12, 16, 20), C = 0;
//   acc:    products in [1, 4), C = +-2^e (e = 4, 8, 12, 16).
// For each it prints the largest and the mean error of D against the exact
// sum in units of ulp(max |addend|) = 2^(floor(log2 max) - 23), where the
// addends are the 8 products and C, and the mean signed error (a bias shows
// truncation).  f32 round-to-nearest of the exact sum would give <= 0.5.
// Then the instruction's rate: 4, 8 or 16 warps per SM each issuing 8
// independent chains, in TFLOP/s, beside bf16 m16n8k16 for scale.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1, const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]), "f"(c[1]),
        "f"(c[2]), "f"(c[3]));
}

// one warp per problem: A (16 x 8, row-major), B (8 x 8, [k][n]), C, D (16 x 8)
__global__ void probe(const float* A, const float* B, const float* C, float* D) {
  const int p = blockIdx.x, lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const float* a = A + p * 128;
  const float* b = B + p * 64;
  uint32_t ar[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                    __float_as_uint(a[g * 8 + t + 4]), __float_as_uint(a[(g + 8) * 8 + t + 4])};
  const uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  const float* c = C + p * 128;
  float cr[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                 c[(g + 8) * 8 + 2 * t + 1]};
  float d[4];
  mma_tf32(d, ar, b0, b1, cr);
  float* o = D + p * 128;
  o[g * 8 + 2 * t] = d[0];
  o[g * 8 + 2 * t + 1] = d[1];
  o[(g + 8) * 8 + 2 * t] = d[2];
  o[(g + 8) * 8 + 2 * t + 1] = d[3];
}

// issue rate: each warp runs `iters` rounds of 8 independent MMA chains
template <bool BF16>
__global__ void rate(float* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  float d[8][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[j & 3]), "r"(a[0]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                     "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                     : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[j & 3]), "r"(a[0]));
    }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) acc += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

template <bool BF16>
static void run_rate(int warps_per_block, int blocks_per_sm) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * blocks_per_sm, threads = 32 * warps_per_block, iters = 4096;
  float* out;
  cudaMalloc(&out, static_cast<size_t>(blocks) * threads * 4);
  rate<BF16><<<blocks, threads>>>(out, 16);  // warm-up
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0), cudaEventCreate(&t1);
  cudaEventRecord(t0);
  rate<BF16><<<blocks, threads>>>(out, iters);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms = 0;
  cudaEventElapsedTime(&ms, t0, t1);
  const double flops = 2.0 * 16 * 8 * (BF16 ? 16 : 8) * 8.0 * iters * (threads / 32) * blocks;
  printf("{\"case\": \"rate\", \"type\": \"%s\", \"warps_per_sm\": %d, \"ms\": %.4f, "
         "\"tflops\": %.1f}\n", BF16 ? "bf16 m16n8k16" : "tf32 m16n8k8",
         warps_per_block * blocks_per_sm, ms, flops / ms / 1e9);
  cudaFree(out);
}

static uint64_t rng = 0x9E3779B97F4A7C15ull;
static double uni() {  // [0, 1)
  rng ^= rng << 13, rng ^= rng >> 7, rng ^= rng << 17;
  return (rng >> 11) * (1.0 / 9007199254740992.0);
}
static float tf32(double x) {  // x truncated to 11 significant bits (exact in TF32)
  float f = static_cast<float>(x);
  uint32_t u;
  memcpy(&u, &f, 4);
  u &= 0xffffe000u;
  memcpy(&f, &u, 4);
  return f;
}
static double sgn() { return uni() < 0.5 ? -1.0 : 1.0; }

static void run(const char* name, int e, int mode, int n) {
  std::vector<float> A(n * 128), B(n * 64), C(n * 128), D(n * 128);
  for (int p = 0; p < n; ++p) {
    for (int i = 0; i < 128; ++i) A[p * 128 + i] = tf32(sgn() * (1.0 + uni()));
    for (int i = 0; i < 64; ++i) B[p * 64 + i] = tf32(sgn() * (1.0 + uni()));
    if (mode == 1)  // one large product per row: a[r][0] scaled by 2^e
      for (int r = 0; r < 16; ++r) A[p * 128 + r * 8] = std::ldexp(A[p * 128 + r * 8], e);
    for (int i = 0; i < 128; ++i) C[p * 128 + i] = mode == 2 ? sgn() * std::ldexp(1.0, e) : 0.f;
  }
  float *dA, *dB, *dC, *dD;
  cudaMalloc(&dA, A.size() * 4), cudaMalloc(&dB, B.size() * 4);
  cudaMalloc(&dC, C.size() * 4), cudaMalloc(&dD, D.size() * 4);
  cudaMemcpy(dA, A.data(), A.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dB, B.data(), B.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(dC, C.data(), C.size() * 4, cudaMemcpyHostToDevice);
  probe<<<n, 32>>>(dA, dB, dC, dD);
  cudaError_t err = cudaMemcpy(D.data(), dD, D.size() * 4, cudaMemcpyDeviceToHost);
  if (err != cudaSuccess) {
    printf("CUDA error %s\n", cudaGetErrorString(err));
    return;
  }
  double worst = 0, sum = 0, bias = 0;
  long cnt = 0;
  for (int p = 0; p < n; ++p)
    for (int r = 0; r < 16; ++r)
      for (int c = 0; c < 8; ++c) {
        double exact = C[p * 128 + r * 8 + c], mx = std::fabs(exact);
        for (int k = 0; k < 8; ++k) {
          const double pr = static_cast<double>(A[p * 128 + r * 8 + k]) * B[p * 64 + k * 8 + c];
          exact += pr;
          mx = std::fmax(mx, std::fabs(pr));
        }
        const double ulp = std::ldexp(1.0, static_cast<int>(std::floor(std::log2(mx))) - 23);
        const double e_ = (D[p * 128 + r * 8 + c] - exact) / ulp;
        // signed toward zero of the exact sum: negative = truncated toward 0
        bias += exact >= 0 ? e_ : -e_;
        worst = std::fmax(worst, std::fabs(e_));
        sum += std::fabs(e_);
        ++cnt;
      }
  printf("{\"case\": \"%s\", \"e\": %d, \"max_err_ulp\": %.3f, \"mean_abs_err_ulp\": %.4f, "
         "\"mean_err_toward_magnitude_ulp\": %.4f, \"sums\": %ld}\n",
         name, e, worst, sum / cnt, bias / cnt, cnt);
  cudaFree(dA), cudaFree(dB), cudaFree(dC), cudaFree(dD);
}

int main() {
  const int n = 4096;
  run("same", 0, 0, n);
  for (int e : {4, 8, 12, 16, 20}) run("spread", e, 1, n);
  for (int e : {4, 8, 12, 16}) run("acc", e, 2, n);
  for (int w : {4, 8, 16}) run_rate<false>(w, 1), run_rate<true>(w, 1);
  return 0;
}
