// K3 — fused confidence threshold + top-k + greedy NMS, per image.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_kernels.py:_pallas_nms_topk (body _nms_topk_kernel), and holds
// the slot layout of its XLA twin _xla_nms_topk (the path's default there):
// slot j is the j-th candidate in lax.top_k order — score descending, ties
// to the lower index, and below-conf slots (score -inf) filled with the
// lowest indices not yet chosen — suppressed slots keep their place with
// keep = false.
//
// On the card: one block of 256 threads per image. The masked scores are
// mapped once to order-preserving uint32 keys in a scratch row; each of
// the k passes is a block-wide max over (key, lower index) packed into 64
// bits, after which the winner's key is set to 0 — below every real key,
// -inf included — so it is never chosen again. Then k threads gather the
// boxes, and one thread runs the k×k IoU (no +1, union == 0 → 1) and the
// greedy suppression in slot order. Bound: latency — k dependent block
// reductions over N (10647 at 416²) keys that stay in L1/L2; the bytes
// (N·(4+16) per image) are small. The IoU arithmetic uses NaN-propagating
// min/max and is compiled without FMA contraction, so it rounds exactly as
// ops/boxes.py:iou_no_plus_one_pairwise does.
#include "common.cuh"

namespace mdcv {

constexpr int kMaxK = 64;

__device__ __forceinline__ uint32_t order_key(float v) {
  if (v == 0.f) v = 0.f;  // -0 and +0 tie, as they compare equal
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // -inf → 0x007fffff
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }  // keeps NaN

__global__ void nms_topk_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                                uint32_t* __restrict__ keys, float* __restrict__ out_boxes,
                                float* __restrict__ out_scores, int32_t* __restrict__ out_idx,
                                bool* __restrict__ out_keep, int N, int k, float conf,
                                float overlap) {
  __shared__ unsigned long long scratch[32];
  __shared__ int top_idx[kMaxK];
  __shared__ float cand[kMaxK][4];
  __shared__ float top_val[kMaxK];
  const size_t b = blockIdx.x;
  const float* sc = scores + b * N;
  uint32_t* key = keys + b * N;

  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float s = sc[i];
    key[i] = order_key(s > conf ? s : -INFINITY);
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    unsigned long long best = 0ull;
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      const unsigned long long packed =
          ((unsigned long long)key[i] << 32) | (0xffffffffu - (uint32_t)i);
      best = packed > best ? packed : best;
    }
    best = block_max_u64(best, scratch);
    const int win = int(0xffffffffu - (uint32_t)(best & 0xffffffffull));
    if (threadIdx.x == 0) {
      top_idx[j] = win;
      key[win] = 0u;
    }
    __syncthreads();  // key[win] = 0 is seen by the next pass
  }

  const float* bx = boxes + b * N * 4;
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    const int i = top_idx[t];
    const float s = sc[i];
    top_val[t] = s > conf ? s : -INFINITY;
    for (int c = 0; c < 4; ++c) cand[t][c] = bx[(size_t)i * 4 + c];
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    bool alive[kMaxK];
    for (int t = 0; t < k; ++t) alive[t] = isfinite(top_val[t]);
    for (int i = 0; i < k; ++i) {
      const bool kept = alive[i];
      out_keep[b * k + i] = kept;
      if (!kept) continue;
      const float area_i = (cand[i][2] - cand[i][0]) * (cand[i][3] - cand[i][1]);
      for (int j = i + 1; j < k; ++j) {
        const float x1 = max_nan(cand[i][0], cand[j][0]);
        const float y1 = max_nan(cand[i][1], cand[j][1]);
        const float x2 = min_nan(cand[i][2], cand[j][2]);
        const float y2 = min_nan(cand[i][3], cand[j][3]);
        const float inter = clamp0(x2 - x1) * clamp0(y2 - y1);
        const float area_j = (cand[j][2] - cand[j][0]) * (cand[j][3] - cand[j][1]);
        const float uni = area_i + area_j - inter;
        const float iou = inter / (uni == 0.f ? 1.f : uni);
        if (iou > overlap) alive[j] = false;
      }
    }
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    out_scores[b * k + t] = top_val[t];
    out_idx[b * k + t] = top_idx[t];
    for (int c = 0; c < 4; ++c) out_boxes[(b * k + t) * 4 + c] = cand[t][c];
  }
}

}  // namespace mdcv

extern "C" int mdcv_nms_topk(const void* boxes, const void* scores, void* keys, void* out_boxes,
                             void* out_scores, void* out_idx, void* out_keep, int B, int N, int k,
                             float conf, float overlap, void* stream) {
  if (k < 1 || k > mdcv::kMaxK || N < k) return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  mdcv::nms_topk_kernel<<<B, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<uint32_t*>(keys), static_cast<float*>(out_boxes),
      static_cast<float*>(out_scores), static_cast<int32_t*>(out_idx),
      static_cast<bool*>(out_keep), N, k, conf, overlap);
  return int(cudaGetLastError());
}
