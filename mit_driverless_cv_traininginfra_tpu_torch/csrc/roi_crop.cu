// K1 — compacted bilinear ROI crop.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_crop.py:roi_crop_windowed (body _make_kernel). That kernel DMAs a
// (256, 768) window of the (H, W·C) frame into VMEM and resamples it with
// two hat-matrix matmuls on the MXU; the window and its 8-row/128-lane
// alignment are Mosaic constraints that also cap the box size.
//
// On the card: one block per crop, threads over the (out_h, out_w, C)
// output. Each output reads its two y taps at each of its two x taps
// straight from the NHWC frame, so there is no window and no box-size
// limit. Bound: bytes — per crop ~4 reads of 2-4 bytes per output element
// from L2-resident frames (a bf16 416² frame is 1 MB) and 19.2k stores; no
// FLOP worth counting. The tap indices and weights of a crop's 80 rows and
// 80 columns are computed once per block into shared memory.
//
// Numerics reproduce ops/image.py:roi_crop_bilinear_indexed exactly:
// - tap weight = clip(1 - |s - j|, 0, 1) in f32, rounded to the frame dtype
//   (ops/image.py:_hat_matrix then .astype(frames.dtype));
// - row value = w1*f1 + w0*f0 in f32 (fmaf over the rounded product of the
//   lower tap, the order a matmul accumulates in), rounded to the frame
//   dtype before the x pass — the two-stage rounding of the two einsums;
// - tap indices are clamped into the frame, so NaN or inf sample
//   coordinates (from overflowing box decodes) never read out of bounds.
#include "common.cuh"

namespace mdcv {

struct Tap {
  int i0, i1;    // source indices, always inside [0, size)
  float w0, w1;  // weights, already rounded to the frame dtype
};

__device__ __forceinline__ float hat(float s, float j) {
  const float w = 1.f - fabsf(s - j);
  return w < 0.f ? 0.f : (w > 1.f ? 1.f : w);  // NaN passes through
}

template <typename T>
__device__ __forceinline__ Tap make_tap(float s, int size) {
  const float f = floorf(s);
  // NaN and -inf land on 0, +inf on size-1: reads stay in the frame
  const int i0 = f >= 0.f ? (f <= float(size - 1) ? int(f) : size - 1) : 0;
  Tap t;
  t.i0 = i0;
  t.w0 = to_f32(from_f32<T>(hat(s, float(i0))));
  if (i0 + 1 <= size - 1) {
    t.i1 = i0 + 1;
    t.w1 = to_f32(from_f32<T>(hat(s, float(i0 + 1))));
  } else {
    t.i1 = i0;
    t.w1 = 0.f;
  }
  return t;
}

template <typename T>
__global__ void roi_crop_kernel(const T* __restrict__ frames, const float* __restrict__ sx,
                                const float* __restrict__ sy, const int32_t* __restrict__ fidx,
                                T* __restrict__ out, int B, int H, int W, int C, int out_h,
                                int out_w) {
  extern __shared__ Tap taps[];  // out_h row taps, then out_w column taps
  const int n = blockIdx.x;
  for (int t = threadIdx.x; t < out_h + out_w; t += blockDim.x) {
    taps[t] = t < out_h ? make_tap<T>(sy[(size_t)n * out_h + t], H)
                        : make_tap<T>(sx[(size_t)n * out_w + (t - out_h)], W);
  }
  __syncthreads();
  int f = fidx[n];
  f = f < 0 ? 0 : (f >= B ? B - 1 : f);
  const T* fr = frames + (size_t)f * H * W * C;
  T* o = out + (size_t)n * out_h * out_w * C;
  const int total = out_h * out_w * C;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int c = idx % C;
    const int j = (idx / C) % out_w;
    const int i = idx / (C * out_w);
    const Tap ty = taps[i];
    const Tap tx = taps[out_h + j];
    const T* r0 = fr + (size_t)ty.i0 * W * C + c;
    const T* r1 = fr + (size_t)ty.i1 * W * C + c;
    // y pass at the two x taps, each rounded to the frame dtype
    const float a = to_f32(from_f32<T>(
        fmaf(ty.w1, to_f32(r1[tx.i0 * C]), ty.w0 * to_f32(r0[tx.i0 * C]))));
    const float b = to_f32(from_f32<T>(
        fmaf(ty.w1, to_f32(r1[tx.i1 * C]), ty.w0 * to_f32(r0[tx.i1 * C]))));
    o[idx] = from_f32<T>(fmaf(tx.w1, b, tx.w0 * a));
  }
}

template <typename T>
cudaError_t launch(const void* frames, const float* sx, const float* sy, const int32_t* fidx,
                   void* out, int N, int B, int H, int W, int C, int out_h, int out_w,
                   cudaStream_t stream) {
  const size_t smem = sizeof(Tap) * (out_h + out_w);
  roi_crop_kernel<T><<<N, 256, smem, stream>>>(static_cast<const T*>(frames), sx, sy, fidx,
                                               static_cast<T*>(out), B, H, W, C, out_h, out_w);
  return cudaGetLastError();
}

}  // namespace mdcv

extern "C" int mdcv_roi_crop(const void* frames, const void* sx, const void* sy,
                             const void* fidx, void* out, int N, int B, int H, int W, int C,
                             int out_h, int out_w, int dtype, void* stream) {
  if (N == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto fsx = static_cast<const float*>(sx);
  auto fsy = static_cast<const float*>(sy);
  auto fi = static_cast<const int32_t*>(fidx);
  if (dtype == 0)
    return mdcv::launch<float>(frames, fsx, fsy, fi, out, N, B, H, W, C, out_h, out_w, s);
  if (dtype == 1)
    return mdcv::launch<__nv_bfloat16>(frames, fsx, fsy, fi, out, N, B, H, W, C, out_h, out_w,
                                       s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mdcv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
