// K2 — fused flat softmax + soft-argmax, forward.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_kernels.py:_pallas_softargmax (body _softargmax_kernel), which
// runs max → exp → sum → normalise → two weighted sums on 64-row VMEM
// tiles of the (M, H·W) logits.
//
// On the card: one block of 256 threads per row of H·W (6400 at 80×80), so
// the M = 7·crops rows spread over all SMs. Three sweeps over the row —
// max; exp and sum; normalise, store the probabilities and accumulate
// E[x], E[y] — all in f32 whatever the logits dtype. Bound: bytes (one
// read of the row per sweep, the later two from L1/L2, one write of the
// probabilities) and the exp rate; the row never leaves the SM between
// sweeps except through cache. The coordinate rows xv, yv are inputs built
// on the host bit-equal to the JAX package's linspace grids.
#include "common.cuh"

namespace mdcv {

template <typename T>
__global__ void softargmax_kernel(const T* __restrict__ logits, const float* __restrict__ xv,
                                  const float* __restrict__ yv, T* __restrict__ probs,
                                  float* __restrict__ pts, int hw) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* z = logits + row * hw;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) m = max_nan(m, to_f32(z[i]));
  m = block_max_nan(m, scratch);
  float s = 0.f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) s += expf(to_f32(z[i]) - m);
  s = block_sum(s, scratch);
  float ex = 0.f, ey = 0.f;
  T* p_out = probs + row * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float p = expf(to_f32(z[i]) - m) / s;
    p_out[i] = from_f32<T>(p);
    ex += p * xv[i];
    ey += p * yv[i];
  }
  ex = block_sum(ex, scratch);
  ey = block_sum(ey, scratch);
  if (threadIdx.x == 0) {
    pts[2 * row] = ex;
    pts[2 * row + 1] = ey;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const float* xv, const float* yv, void* probs, float* pts,
                   int M, int hw, cudaStream_t stream) {
  softargmax_kernel<T><<<M, 256, 0, stream>>>(static_cast<const T*>(logits), xv, yv,
                                              static_cast<T*>(probs), pts, hw);
  return cudaGetLastError();
}

}  // namespace mdcv

extern "C" int mdcv_softargmax(const void* logits, const void* xv, const void* yv, void* probs,
                               void* pts, int M, int hw, int dtype, void* stream) {
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xv);
  auto y = static_cast<const float*>(yv);
  auto p = static_cast<float*>(pts);
  if (dtype == 0) return mdcv::launch<float>(logits, x, y, probs, p, M, hw, s);
  if (dtype == 1) return mdcv::launch<__nv_bfloat16>(logits, x, y, probs, p, M, hw, s);
  return int(cudaErrorInvalidValue);
}
