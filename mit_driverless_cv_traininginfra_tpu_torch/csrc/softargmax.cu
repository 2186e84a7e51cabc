// K2 — fused flat softmax + soft-argmax, forward and backward.
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
//
// The backward replaces the XLA code of the same file's custom VJP
// (pallas_kernels.py:_bwd): with gp = g_probs + g_x·xv + g_y·yv over a
// row, dz = p·(gp − Σ gp·p). One block per row again: a sweep that forms
// gp and reduces Σ gp·p, then an elementwise sweep that writes dz in the
// probabilities' dtype; g_probs may be null (treated as zeros). All in
// f32; bound: bytes (probabilities, their gradient and dz, once each).
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

template <typename T>
__global__ void softargmax_bwd_kernel(const T* __restrict__ probs, const T* __restrict__ g_probs,
                                      const float* __restrict__ g_pts,
                                      const float* __restrict__ xv,
                                      const float* __restrict__ yv, T* __restrict__ dz,
                                      int hw) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x;
  const T* p = probs + row * hw;
  const T* gpr = g_probs ? g_probs + row * hw : nullptr;
  const float gx = g_pts[2 * row], gy = g_pts[2 * row + 1];
  float s = 0.f;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float up = gx * xv[i] + gy * yv[i];
    const float gp = gpr ? to_f32(gpr[i]) + up : up;
    s += gp * to_f32(p[i]);
  }
  s = block_sum(s, scratch);
  T* out = dz + row * hw;
  for (int i = threadIdx.x; i < hw; i += blockDim.x) {
    const float up = gx * xv[i] + gy * yv[i];
    const float gp = gpr ? to_f32(gpr[i]) + up : up;
    out[i] = from_f32<T>(to_f32(p[i]) * (gp - s));
  }
}

template <typename T>
cudaError_t launch_bwd(const void* probs, const void* g_probs, const float* g_pts,
                       const float* xv, const float* yv, void* dz, int M, int hw,
                       cudaStream_t stream) {
  softargmax_bwd_kernel<T><<<M, 256, 0, stream>>>(
      static_cast<const T*>(probs), static_cast<const T*>(g_probs), g_pts, xv, yv,
      static_cast<T*>(dz), hw);
  return cudaGetLastError();
}

}  // namespace mdcv

extern "C" int mdcv_softargmax_bwd(const void* probs, const void* g_probs, const void* g_pts,
                                   const void* xv, const void* yv, void* dz, int M, int hw,
                                   int dtype, void* stream) {
  if (M == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(g_pts);
  auto x = static_cast<const float*>(xv);
  auto y = static_cast<const float*>(yv);
  if (dtype == 0) return mdcv::launch_bwd<float>(probs, g_probs, g, x, y, dz, M, hw, s);
  if (dtype == 1)
    return mdcv::launch_bwd<__nv_bfloat16>(probs, g_probs, g, x, y, dz, M, hw, s);
  return int(cudaErrorInvalidValue);
}

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
