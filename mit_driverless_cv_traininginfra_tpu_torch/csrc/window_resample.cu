// window_resample — a windowed gather plus a two-tap column resample: for
// crop i, rows 0..rows-1 of the window at frames[fidx[i], r0[i]:, l0[i]:]
// (frames (B, H, WF) bf16 with WF = W·ch interleaved channels), then
//
//   out[i, j, ch·m + c] = Σ_w bf16(hat(sx[i, m] − w)) · win[j, ch·w + c],
//   hat(d) = clip(1 − |d|, 0, 1) in f32,  w ∈ [0, win_w)
//
// summed in f32 and written as bf16.
//
// Replaces the TPU probes tools/probe_crop_kernel.py:77-171 (P21 and P22,
// kresample): a scalar-prefetch DMA of a 256×768 window into VMEM, then one
// (80, 768)·(768, 240) matmul against a hat matrix built from iotas, whose
// 8-row and 128-lane alignment rules were Mosaic's. Here there is no
// window copy and no matrix: at most two taps of hat() are non-zero
// (w = floor(s) and floor(s) + 1), so each output reads exactly those two
// window values. A bf16·bf16 product is exact in f32, so the sum of the two
// taps rounds once, in any order, and the result equals the plain version
// (ops/window_resample.py: the 256-wide product) bit for bit.
//
// One thread per output value, consecutive threads on consecutive output
// lanes (coalesced stores, reads within one window row). Bound: bytes — each
// output reads two bf16 values of one row and writes one. A window outside
// its frame traps: the launch fails and the error surfaces at the next
// synchronisation, where the plain version raises IndexError; nothing is
// read out of bounds.
#include "common.cuh"

namespace mdcv {
namespace wr {

__global__ void window_resample_kernel(const __nv_bfloat16* __restrict__ frames,
                                       const int* __restrict__ fidx, const int* __restrict__ r0,
                                       const int* __restrict__ l0, const float* __restrict__ sx,
                                       __nv_bfloat16* __restrict__ out, long long total, int B,
                                       int H, int WF, int rows, int M, int win_w, int ch) {
  const int lanes = M * ch;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int lane = int(e % lanes);
    const long long row_id = e / lanes;
    const int j = int(row_id % rows), i = int(row_id / rows);
    const int m = lane / ch, c = lane % ch;
    const float s = sx[size_t(i) * M + m];
    const int f = fidx[i], r = r0[i], l = l0[i];
    if (f < 0 || f >= B || r < 0 || r > H - rows || l < 0 || l > WF - win_w * ch) __trap();
    const __nv_bfloat16* row = frames + (size_t(f) * H + r + j) * size_t(WF) + l;
    // a NaN coordinate makes every tap NaN, as clip(NaN) does in the plain
    // version; ±inf reaches no tap (hat 0 everywhere)
    float acc = s != s ? s : 0.f;
    const float w0 = floorf(s);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float wf = w0 + float(t);
      if (!(wf >= 0.f && wf < float(win_w))) continue;
      const float hat = fminf(fmaxf(1.f - fabsf(s - wf), 0.f), 1.f);
      const float hb = __bfloat162float(__float2bfloat16_rn(hat));
      acc = acc + hb * __bfloat162float(row[int(wf) * ch + c]);
    }
    out[e] = __float2bfloat16_rn(acc);
  }
}

}  // namespace wr
}  // namespace mdcv

// frames (B, H, WF) bf16; fidx, r0, l0 (n,) int32 (window origin: frame,
// row, lane); sx (n, M) f32 window columns → out (n, rows, M·ch) bf16.
// Every window (rows × win_w·ch lanes) must lie inside its frame.
extern "C" int mdcv_window_resample(const void* frames, const void* fidx, const void* r0,
                                    const void* l0, const void* sx, void* out, int n, int B,
                                    int H, int WF, int rows, int M, int win_w, int ch,
                                    void* stream) {
  if (B <= 0 || H <= 0 || WF <= 0 || rows <= 0 || M <= 0 || win_w <= 0 || ch <= 0 ||
      rows > H || win_w * ch > WF)
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long total = (long long)n * rows * M * ch;
  const long long want = (total + 255) / 256;
  const int blocks = int(want < 65536 ? want : 65536);
  mdcv::wr::window_resample_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(frames), static_cast<const int*>(fidx),
      static_cast<const int*>(r0), static_cast<const int*>(l0), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(out), total, B, H, WF, rows, M, win_w, ch);
  return int(cudaGetLastError());
}
