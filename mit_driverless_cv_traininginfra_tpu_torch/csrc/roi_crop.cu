// K1 — compacted bilinear ROI crop, in one launch per call.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_crop.py:roi_crop_windowed (body _make_kernel). That kernel DMAs a
// (256, 768) window of the (H, W·C) frame into VMEM and resamples it with
// two hat-matrix matmuls on the MXU; the window and its 8-row/128-lane
// alignment are Mosaic constraints that also cap the box size.
//
// Bound: bytes, and at the served sizes the launch itself. A crop reads
// its taps (about 4 reads of C values per output pixel, from L2-resident
// frames: a bf16 416² frame is 1 MB) and writes 19.2k values (80×80×3);
// the arithmetic is a few multiply-adds per value. So the design removes
// everything that is not the one kernel and keeps the card busy:
// - the kernel reads the boxes (f32 or bf16, any strides) and the frame
//   indices (int32 or int64) itself and computes the sampling coordinates,
//   bit for bit as ops/image.py:_crop_coords does on the CPU (the JAX
//   package's bits): js = (j + 0.5) / out_w as an IEEE quotient, then
//   x0 + bw·js − 0.5, the clip into [x0, x1 − 1] and into the frame with
//   NaN-propagating min/max; no other launch reaches the card;
// - one block per (crop, band of kMaxRows output rows): 64 crops of 80 rows
//   give 640 blocks on 132 SMs, where one block per crop gave 64;
// - the channel count C is a template constant for C ∈ {1, 3, 4} (the JAX
//   kernel's set, pallas_crop.py:51-58), so no thread divides by a runtime
//   C; C = 0 instantiates the same kernel with C read at run time;
// - one thread makes one output pixel's C channels; the band's outputs,
//   contiguous in the output, are staged in shared memory and stored with
//   16-byte stores when the band is 16-byte aligned.
//
// Numerics reproduce ops/image.py:roi_crop_bilinear_indexed exactly:
// - tap weight = clip(1 - |s - j|, 0, 1) in f32, rounded to the frame dtype
//   (ops/image.py:_hat_matrix then .astype(frames.dtype));
// - row value = w1*f1 + w0*f0 in f32 (fmaf over the rounded product of the
//   lower tap, the order a matmul accumulates in), rounded to the frame
//   dtype before the x pass — the two-stage rounding of the two einsums;
// - tap indices are clamped into the frame, so NaN or inf sample
//   coordinates (from overflowing box decodes) never read out of bounds;
//   the frame index is clamped into the batch.
#include "common.cuh"

namespace mdcv {

constexpr int kCropThreads = 128;
constexpr int kMaxRows = 8;                // output rows per block
constexpr int kStageBytes = 32 * 1024;     // staged outputs per block, at most

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

// ops/image.py:_crop_coords for sample j of out along one axis: the box
// edges lo, hi (f32), the frame size; -fmad=false keeps every rounding
__device__ __forceinline__ float crop_coord(float lo, float hi, int j, int out, int size) {
  const float extent = max_nan(__fsub_rn(hi, lo), 1e-3f);      // clamp(min=1e-3)
  const float js = __fdiv_rn(__fadd_rn(float(j), 0.5f), float(out));
  float s = __fsub_rn(__fadd_rn(lo, __fmul_rn(extent, js)), 0.5f);
  s = min_nan(max_nan(s, lo), __fsub_rn(hi, 1.f));               // _clip
  return min_nan(max_nan(s, 0.f), float(size - 1));              // clamp
}

struct BoxArgs {
  const void* boxes;
  long long s0, s1;  // element strides of (N, 4)
  int bf16;          // 0: f32, 1: bf16
  const void* fidx;
  long long fs;      // element stride
  int i64;           // 0: int32, 1: int64
};

__device__ __forceinline__ float box_at(const BoxArgs& a, int n, int k) {
  const long long o = n * a.s0 + k * a.s1;
  return a.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.boxes)[o])
                : static_cast<const float*>(a.boxes)[o];
}

// one output value from its four taps: the y pass at the two x taps, each
// rounded to the frame dtype, then the x pass
template <typename T>
__device__ __forceinline__ T lerp2(const T* r0, const T* r1, int x0, int x1, const Tap& ty,
                                   const Tap& tx) {
  const float a = to_f32(from_f32<T>(fmaf(ty.w1, to_f32(r1[x0]), ty.w0 * to_f32(r0[x0]))));
  const float b = to_f32(from_f32<T>(fmaf(ty.w1, to_f32(r1[x1]), ty.w0 * to_f32(r0[x1]))));
  return from_f32<T>(fmaf(tx.w1, b, tx.w0 * a));
}

template <typename T, int kC>
__global__ void __launch_bounds__(kCropThreads)
    roi_crop_kernel(const T* __restrict__ frames, BoxArgs ba, T* __restrict__ out, int B,
                    int H, int W, int C_rt, int out_h, int out_w, int rows, int bands,
                    int staged) {
  const int C = kC ? kC : C_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* taps = reinterpret_cast<Tap*>(smem);  // rows row taps, then out_w column taps
  T* stage = reinterpret_cast<T*>(smem + sizeof(Tap) * (kMaxRows + out_w));
  const int n = blockIdx.x / bands, band = blockIdx.x % bands;
  const int i_lo = band * rows;
  const int nrows = min(rows, out_h - i_lo);
  for (int t = threadIdx.x; t < nrows + out_w; t += kCropThreads) {
    if (t < nrows) {
      taps[t] =
          make_tap<T>(crop_coord(box_at(ba, n, 1), box_at(ba, n, 3), i_lo + t, out_h, H), H);
    } else {
      const int j = t - nrows;
      taps[kMaxRows + j] =
          make_tap<T>(crop_coord(box_at(ba, n, 0), box_at(ba, n, 2), j, out_w, W), W);
    }
  }
  long long f = ba.i64 ? static_cast<const long long*>(ba.fidx)[n * ba.fs]
                       : static_cast<const int*>(ba.fidx)[n * ba.fs];
  f = f < 0 ? 0 : (f >= B ? B - 1 : f);
  __syncthreads();
  const T* fr = frames + size_t(f) * H * W * C;
  const size_t band_off = (size_t(n) * out_h + i_lo) * out_w * C;
  T* dst = staged ? stage : out + band_off;
  const int npix = nrows * out_w;
  for (int p = threadIdx.x; p < npix; p += kCropThreads) {
    const int i = p / out_w, j = p - i * out_w;
    const Tap ty = taps[i];
    const Tap tx = taps[kMaxRows + j];
    const T* r0 = fr + size_t(ty.i0) * W * C;
    const T* r1 = fr + size_t(ty.i1) * W * C;
    const int x0 = tx.i0 * C, x1 = tx.i1 * C;
    T* o = dst + size_t(p) * C;
    if constexpr (kC > 0) {
#pragma unroll
      for (int c = 0; c < kC; ++c) o[c] = lerp2<T>(r0, r1, x0 + c, x1 + c, ty, tx);
    } else {
      for (int c = 0; c < C; ++c) o[c] = lerp2<T>(r0, r1, x0 + c, x1 + c, ty, tx);
    }
  }
  if (!staged) return;
  __syncthreads();
  const size_t bytes = size_t(npix) * C * sizeof(T);
  unsigned char* g = reinterpret_cast<unsigned char*>(out + band_off);
  if ((reinterpret_cast<uintptr_t>(g) | bytes) % 16 == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(stage);
    int4* g4 = reinterpret_cast<int4*>(g);
    for (size_t k = threadIdx.x; k < bytes / 16; k += kCropThreads) g4[k] = s4[k];
  } else {
    T* go = out + band_off;
    for (size_t k = threadIdx.x; k < size_t(npix) * C; k += kCropThreads) go[k] = stage[k];
  }
}

template <typename T, int kC>
cudaError_t launch_c(const void* frames, const BoxArgs& ba, void* out, int N, int B, int H,
                     int W, int C, int out_h, int out_w, cudaStream_t stream) {
  const size_t row_bytes = size_t(out_w) * C * sizeof(T);
  int rows = int(kStageBytes / (row_bytes ? row_bytes : 1));
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int staged = row_bytes * rows <= kStageBytes;
  const int bands = (out_h + rows - 1) / rows;
  const size_t smem = sizeof(Tap) * (kMaxRows + out_w) + (staged ? row_bytes * rows : 0);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // out_w above ~2900
  const long long blocks = (long long)N * bands;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  roi_crop_kernel<T, kC><<<unsigned(blocks), kCropThreads, smem, stream>>>(
      static_cast<const T*>(frames), ba, static_cast<T*>(out), B, H, W, C, out_h, out_w, rows,
      bands, staged);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* frames, const BoxArgs& ba, void* out, int N, int B, int H,
                   int W, int C, int out_h, int out_w, cudaStream_t stream) {
  switch (C) {
    case 1: return launch_c<T, 1>(frames, ba, out, N, B, H, W, C, out_h, out_w, stream);
    case 3: return launch_c<T, 3>(frames, ba, out, N, B, H, W, C, out_h, out_w, stream);
    case 4: return launch_c<T, 4>(frames, ba, out, N, B, H, W, C, out_h, out_w, stream);
    default: return launch_c<T, 0>(frames, ba, out, N, B, H, W, C, out_h, out_w, stream);
  }
}

}  // namespace mdcv

// boxes: (N, 4) with element strides bs0, bs1, box_dtype 0 f32 / 1 bf16;
// fidx: (N,) with element stride fs, fidx_dtype 0 int32 / 1 int64
extern "C" int mdcv_roi_crop(const void* frames, const void* boxes, long long bs0,
                             long long bs1, int box_dtype, const void* fidx, long long fs,
                             int fidx_dtype, void* out, int N, int B, int H, int W, int C,
                             int out_h, int out_w, int dtype, void* stream) {
  if (N == 0) return 0;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || out_h <= 0 || out_w <= 0 || box_dtype < 0 ||
      box_dtype > 1 || fidx_dtype < 0 || fidx_dtype > 1)
    return int(cudaErrorInvalidValue);
  const mdcv::BoxArgs ba{boxes, bs0, bs1, box_dtype, fidx, fs, fidx_dtype};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return mdcv::launch<float>(frames, ba, out, N, B, H, W, C, out_h, out_w, s);
  if (dtype == 1)
    return mdcv::launch<__nv_bfloat16>(frames, ba, out, N, B, H, W, C, out_h, out_w, s);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mdcv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
