// Shared-memory lookup costs behind the B2 / B5 designs, measured alone.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/bench_smem_lookup \
//        tools/bench_smem_lookup.cu && build/bench_smem_lookup
//
// One block per SM (132 blocks; 256 and 512 threads) loops over steps in
// which every lane makes 4 table lookups and adds them in order, as one
// step of each design does:
//   random       4 lookups in one shared 4 x 256-entry table at random
//                codes (the lane-per-row scan: a warp's 32 addresses fall
//                in random banks);
//   private      4 lookups in lane-private tables (entry (j, c) of lane l
//                at word (j*256 + c)*32 + l: 32 distinct banks);
//   +shuffle     private, the running sum passed along chains of 4 lanes
//                (__shfl_up_sync), as a systolic scan with lane-private
//                tables and four sub-spaces per lane would;
//   +codes       and each step's codes read from a staged shared chunk;
//   +vote        and a warp vote on the result (the candidate test).
// Prints SM clock cycles (at the device's maximum clock) per warp-step per
// SM for each variant: the shared-memory and issue cost of 128 lookups.
//
// The second group prices the tables of several queries looked up at one
// address (the B6 / B7 block, csrc/adc_topk_multi.cuh).  Each step draws 4
// addresses per lane from a per-lane xorshift (every byte of the word is
// random, so the banks are), one per sub-space of a 4 x 256-entry table,
// and adds every query's entry, in column order, to that query's sum:
//   q1           one query, 4 LDS.32 (lane per row, random banks);
//   q4 x1        four queries, tables one after the other ([4][1024]):
//                4 LDS.32 per address at immediate offsets;
//   q4 x2        interleaved by 2 ([2][1024][2]): 2 LDS.64 per address;
//   q4 x4        interleaved by 4 ([1024][4]): 1 LDS.128 per address.
// Prints SM clock cycles per warp-wide lookup of one query's entry: 1.0 is
// the shared-memory rate (128 bytes per SM clock).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int TAB_BYTES = 4 * 256 * 32 * 4;  // lane-private: 128 KB
constexpr int CODE_BYTES = 16384;

enum Variant { RANDOM, PRIVATE, SHUFFLE, CODES, VOTE };

template <int V>
__global__ void __launch_bounds__(512, 1) step_loop(float* out, int steps, unsigned seed) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* tab = reinterpret_cast<float*>(sm);
  uint32_t* codes = reinterpret_cast<uint32_t*>(sm + TAB_BYTES);
  for (int i = threadIdx.x; i < TAB_BYTES / 4; i += blockDim.x) tab[i] = (i * 7 % 13) * 0.5f;
  for (int i = threadIdx.x; i < CODE_BYTES / 4; i += blockDim.x)
    codes[i] = (i * 2654435761u) ^ seed;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p = lane & 3;
  const float* tl = tab + lane;
  uint32_t word = (threadIdx.x * 2654435761u) ^ seed;
  const uint32_t* cp = codes + ((threadIdx.x >> 5) * 128 + lane) % (CODE_BYTES / 4);
  float d = 0.f, acc = 0.f;
  for (int t = 0; t < steps; ++t) {
    float e0, e1, e2, e3;
    if (V == RANDOM) {
      e0 = tab[word & 0xff];
      e1 = tab[256 + ((word >> 8) & 0xff)];
      e2 = tab[512 + ((word >> 16) & 0xff)];
      e3 = tab[768 + (word >> 24)];
    } else {
      e0 = tl[(word & 0xff) * 32];
      e1 = tl[(256 + ((word >> 8) & 0xff)) * 32];
      e2 = tl[(512 + ((word >> 16) & 0xff)) * 32];
      e3 = tl[(768 + (word >> 24)) * 32];
    }
    if (V >= CODES) {
      cp += 32;
      if (cp >= codes + CODE_BYTES / 4) cp -= CODE_BYTES / 4;
      word = *cp;
    } else {
      word = word * 1664525u + 1013904223u;
    }
    float x = d;
    if (V >= SHUFFLE) {
      x = __shfl_up_sync(0xffffffffu, d, 1, 4);
      if (p == 0) x = 0.f;
    }
    x = __fadd_rn(x, e0);
    x = __fadd_rn(x, e1);
    x = __fadd_rn(x, e2);
    d = __fadd_rn(x, e3);
    if (V >= VOTE && __ballot_sync(0xffffffffu, d < -1.f)) acc += 1.f;
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = d + acc;
}

// Interleave I (1, 2, 4) of NQ (1 or 4) queries' tables, layout
// [NQ / I][1024][I]; 4 addresses a step, NQ entries each.
template <int NQ, int I>
__global__ void __launch_bounds__(512, 1) query_loop(float* out, int steps, unsigned seed) {
  extern __shared__ __align__(16) unsigned char sm[];
  float* tab = reinterpret_cast<float*>(sm);
  for (int i = threadIdx.x; i < NQ * 1024; i += blockDim.x) tab[i] = (i * 7 % 13) * 0.5f;
  __syncthreads();
  uint32_t x = (threadIdx.x + 1) * 2654435761u ^ seed;
  float d[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) d[q] = 0.f;
  for (int t = 0; t < steps; ++t) {
    x ^= x << 13;
    x ^= x >> 17;
    x ^= x << 5;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t a = m * 256 + ((x >> (8 * m)) & 0xffu);
#pragma unroll
      for (int s = 0; s < NQ / I; ++s) {
        const float* p = tab + (s * 1024 + a) * I;
        if constexpr (I == 4) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          d[4 * s] = __fadd_rn(d[4 * s], v.x);
          d[4 * s + 1] = __fadd_rn(d[4 * s + 1], v.y);
          d[4 * s + 2] = __fadd_rn(d[4 * s + 2], v.z);
          d[4 * s + 3] = __fadd_rn(d[4 * s + 3], v.w);
        } else if constexpr (I == 2) {
          const float2 v = *reinterpret_cast<const float2*>(p);
          d[2 * s] = __fadd_rn(d[2 * s], v.x);
          d[2 * s + 1] = __fadd_rn(d[2 * s + 1], v.y);
        } else {
          d[s] = __fadd_rn(d[s], *p);
        }
      }
    }
  }
  float r = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) r += d[q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
}

// SM clocks per warp-wide lookup of one query's entry.
template <int NQ, int I>
double cycles_per_query_lookup(float* out, int steps, int threads, int sms, double hz) {
  const int smem = NQ * 1024 * 4;
  query_loop<NQ, I><<<sms, threads, smem>>>(out, steps, 1);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  query_loop<NQ, I><<<sms, threads, smem>>>(out, steps, 2);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms * 1e-3 * hz / (static_cast<double>(steps) * 4 * NQ * (threads / 32));
}

template <int V>
double cycles_per_warp_step(float* out, int steps, int threads, int sms, double hz) {
  const int smem = TAB_BYTES + CODE_BYTES;
  cudaFuncSetAttribute(step_loop<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  step_loop<V><<<sms, threads, smem>>>(out, steps, 1);
  cudaDeviceSynchronize();
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  step_loop<V><<<sms, threads, smem>>>(out, steps, 2);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  return ms * 1e-3 * hz / (static_cast<double>(steps) * (threads / 32));
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  const double hz = khz * 1e3;
  float* out = nullptr;
  cudaMalloc(&out, prop.multiProcessorCount * 512 * sizeof(float));
  const int steps = 20000;
  std::printf("%s, %d SMs, max SM clock %.0f MHz\n", prop.name, prop.multiProcessorCount,
              hz / 1e6);
  for (int threads : {256, 512}) {
    const int n = prop.multiProcessorCount;
    std::printf(
        "{\"threads\": %d, \"cycles_per_warp_step\": {\"random\": %.2f, \"private\": %.2f, "
        "\"+shuffle\": %.2f, \"+codes\": %.2f, \"+vote\": %.2f}}\n",
        threads, cycles_per_warp_step<RANDOM>(out, steps, threads, n, hz),
        cycles_per_warp_step<PRIVATE>(out, steps, threads, n, hz),
        cycles_per_warp_step<SHUFFLE>(out, steps, threads, n, hz),
        cycles_per_warp_step<CODES>(out, steps, threads, n, hz),
        cycles_per_warp_step<VOTE>(out, steps, threads, n, hz));
  }
  for (int threads : {256, 512}) {
    const int n = prop.multiProcessorCount;
    std::printf(
        "{\"threads\": %d, \"cycles_per_query_lookup\": {\"q1\": %.3f, \"q4 x1\": %.3f, "
        "\"q4 x2\": %.3f, \"q4 x4\": %.3f}}\n",
        threads, cycles_per_query_lookup<1, 1>(out, steps, threads, n, hz),
        cycles_per_query_lookup<4, 1>(out, steps, threads, n, hz),
        cycles_per_query_lookup<4, 2>(out, steps, threads, n, hz),
        cycles_per_query_lookup<4, 4>(out, steps, threads, n, hz));
  }
  const cudaError_t e = cudaGetLastError();
  cudaFree(out);
  if (e != cudaSuccess) {
    std::printf("CUDA error: %s\n", cudaGetErrorString(e));
    return 1;
  }
  return 0;
}
