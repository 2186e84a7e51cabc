// The int8 tensor cores' rates on this card, as the port's kernels drive
// them: mma.sync.m16n8k32 s8 (independent accumulators a warp, warps and
// blocks an SM) and wgmma.m64nNk32 s8 with A in registers and B in shared
// memory (wgmma's a warpgroup issues before it waits, warpgroups a block).
// Built and run by tools/mma_rates.py; prints one line a configuration.
#include <cstdio>

#include "int8_mma.cuh"

using namespace mdcv;

template <int NACC>
__global__ void mma_loop(int* out, int iters) {
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  const int b0 = threadIdx.x * 3, b1 = 7;
  int acc[NACC][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_s8(acc[j], a, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int N, int NT>
__global__ void wgmma_loop(int* out, int iters) {
  __shared__ __align__(128) unsigned char sB[N * 64];
  for (int i = threadIdx.x; i < N * 64; i += blockDim.x) sB[i] = static_cast<unsigned char>(i);
  fence_proxy_async();
  __syncthreads();
  uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u};
  int d[NT][N / 2] = {};
  const uint64_t desc = kmajor_desc(sB);
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if constexpr (N == 128) wgmma_n128(d[t], a, desc);
      else wgmma_n64(d[t], a, desc);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) keep(d[t][i]);
  }
  int s = 0;
  for (int t = 0; t < NT; ++t)
    for (int i = 0; i < N / 2; ++i) s += d[t][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

constexpr int kIters = 2000;

template <typename Launch>
float ms_of(Launch launch, int* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(out, 10);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  launch(out, kIters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  return ms;
}

template <int NACC>
void mma(int* out, int n_sm, int warps, int blocks) {
  const float ms = ms_of([&](int* o, int it) { mma_loop<NACC><<<n_sm * blocks, warps * 32>>>(o, it); }, out);
  const double ops = 2.0 * n_sm * blocks * warps * double(kIters) * NACC * 16 * 8 * 32;
  printf("{\"op\": \"mma.sync.m16n8k32.s8\", \"accumulators\": %d, \"warps_a_block\": %d, "
         "\"blocks_an_sm\": %d, \"ms\": %.6f, \"tops\": %.1f, \"error\": \"%s\"}\n",
         NACC, warps, blocks, ms, ops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

template <int N, int NT>
void wg(int* out, int n_sm, int groups) {
  const float ms = ms_of([&](int* o, int it) { wgmma_loop<N, NT><<<n_sm, groups * 128>>>(o, it); }, out);
  const double ops = 2.0 * n_sm * groups * double(kIters) * NT * 64 * N * 32;
  printf("{\"op\": \"wgmma.m64n%dk32.s8\", \"before_wait\": %d, \"warpgroups_a_block\": %d, "
         "\"ms\": %.6f, \"tops\": %.1f, \"error\": \"%s\"}\n",
         N, NT, groups, ms, ops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int n_sm = 0;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, 0);
  int* out = nullptr;
  cudaMalloc(&out, size_t(n_sm) * 2 * 1024 * sizeof(int));
  mma<8>(out, n_sm, 4, 1);
  mma<8>(out, n_sm, 8, 1);
  mma<16>(out, n_sm, 8, 1);
  mma<24>(out, n_sm, 8, 1);
  mma<16>(out, n_sm, 16, 1);
  mma<16>(out, n_sm, 4, 2);
  wg<64, 1>(out, n_sm, 1);
  wg<64, 2>(out, n_sm, 1);
  wg<64, 5>(out, n_sm, 2);
  wg<128, 1>(out, n_sm, 1);
  wg<128, 2>(out, n_sm, 1);
  wg<128, 2>(out, n_sm, 3);
  wg<128, 1>(out, n_sm, 3);
  cudaFree(out);
  return 0;
}
