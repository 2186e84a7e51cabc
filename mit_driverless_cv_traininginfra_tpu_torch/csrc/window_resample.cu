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
// matrix: at most two taps of hat() are non-zero (w = floor(s) and
// floor(s) + 1), so each output reads exactly those two window values. A
// bf16·bf16 product is exact in f32, so the sum of the two taps rounds
// once, in any order, and the result equals the plain version
// (ops/window_resample.py: the 256-wide product) bit for bit.
//
// Bound: bytes (the window values the taps reach, sx and the output). One
// block per (crop, band of kBand rows), in four steps:
//   1. taps: for each of the crop's M columns, once a block, the value the
//      sum starts from (NaN for a NaN coordinate, else +0), and for each of
//      its two taps the window lane it reads (or −1 outside the window,
//      which a ±inf or NaN coordinate always is) and its bf16-rounded hat,
//      into a shared-memory table; the lowest and the highest window column
//      a tap reaches; thread 0 tests the window against its frame and traps
//      there, before any thread reads the frames;
//   2. staging: each band row's span from the lowest tap to the highest
//      into shared memory, in 8-value chunks on the frames' 16-byte grid:
//      a chunk that lies inside the span is one 16-byte cp.async (no
//      registers), the chunks at its unaligned head and tail are read
//      element by element, and nothing outside the span (so nothing
//      outside the frame) is read;
//   3. resample: a thread takes one output column m, reads its tap entry
//      once and forms its ch values (ch a constant for 1, 3 and 4
//      channels) in each band row, base + hat0·v0 +
//      hat1·v1 in that order from the staged rows, as the plain version
//      rounds them, into an output tile in shared memory: the band's rows
//      are contiguous in `out`, so the tile is their run, laid on the
//      output's 16-byte grid;
//   4. output: the run in 8-value chunks, a whole chunk one 16-byte store,
//      the run's head and tail chunks element by element.
// A window outside its frame traps: the launch fails and the error
// surfaces at the next synchronisation, where the plain version raises
// IndexError.
#include <climits>

#include "common.cuh"

namespace mdcv {
namespace wr {

constexpr int kBand = 16;      // window rows a block resamples
constexpr int kThreads = 256;  // a multiple of 32
constexpr int kMaxSmem = 227 * 1024;

// One output column's taps: the value the sum starts from, both hats as a
// bf16 pair (exact: each was rounded to bf16), and each tap's lane in a
// window row (column · ch), −1 where the tap lies outside the window.
struct __align__(16) Tap {
  float base;
  uint32_t hats;
  int o0, o1;
};

// a 16-byte copy from device to shared memory that bypasses the registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// the 8-element phase of a bf16 address: how far it lies past the 16-byte
// boundary before it, in elements
__device__ __forceinline__ int phase8(const __nv_bfloat16* p) {
  return int((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

// Chunks (jj, q) of the band's R rows, q < chunks, for u = jj·chunks + q
// ≡ tid (mod kThreads): one division a thread, then steps of kThreads. A
// chunk inside the span is one cp.async; the head and tail chunks are
// copied element by element. Returns with the copies landed.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* win, const __nv_bfloat16* row0,
                                           int WF, int stride, int span, int chunks, int R) {
  const int djj = kThreads / chunks, dq = kThreads - djj * chunks;
  int jj = int(threadIdx.x) / chunks, q = int(threadIdx.x) % chunks;
  for (; jj < R; jj += djj, q += dq) {
    if (q >= chunks) q -= chunks, ++jj;
    if (jj >= R) break;
    const __nv_bfloat16* src = row0 + size_t(jj) * WF;
    const int k0 = 8 * q - phase8(src);  // span element of the chunk's first lane
    __nv_bfloat16* dst = win + jj * stride + 8 * q;
    if (k0 >= 0 && k0 + 8 <= span) {
      cp_async16(dst, src + k0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (k0 + e >= 0 && k0 + e < span) dst[e] = src[k0 + e];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// CH: the channels as a constant (1, 3, 4), or 0 for the runtime ch
template <int CH>
__global__ void __launch_bounds__(kThreads)
    window_resample_kernel(const __nv_bfloat16* __restrict__ frames,
                           const int* __restrict__ fidx, const int* __restrict__ r0,
                           const int* __restrict__ l0, const float* __restrict__ sx,
                           __nv_bfloat16* __restrict__ out, int B, int H, int WF, int rows,
                           int M, int win_w, int ch_rt, int stride, int tap_bytes,
                           int tile_bytes) {
  const int ch = CH ? CH : ch_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  Tap* tap = reinterpret_cast<Tap*>(smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem + tap_bytes);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + tap_bytes + tile_bytes);
  __shared__ int part_lo[kThreads / kWarp], part_hi[kThreads / kWarp];
  __shared__ int row_phase[kBand];
  __shared__ const __nv_bfloat16* band_row0;

  const int tid = threadIdx.x;
  const int bands = (rows + kBand - 1) / kBand;
  const int i = blockIdx.x / bands, j0 = (blockIdx.x - i * bands) * kBand;
  const int R = min(kBand, rows - j0);
  if (tid == 0) {
    const int f = fidx[i], r = r0[i], l = l0[i];
    if (f < 0 || f >= B || r < 0 || r > H - rows || l < 0 || l > WF - win_w * ch) __trap();
    band_row0 = frames + (size_t(f) * H + r + j0) * size_t(WF) + l;
  }

  // 1. the tap table, and the span of window columns the taps reach
  int lo = INT_MAX, hi = -1;
  for (int m = tid; m < M; m += kThreads) {
    const float s = sx[size_t(i) * M + m];
    const float w0 = floorf(s);
    float hb[2];
    int o[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float wf = w0 + float(t);
      const bool in = wf >= 0.f && wf < float(win_w);
      const float hat = fminf(fmaxf(1.f - fabsf(s - wf), 0.f), 1.f);
      hb[t] = in ? hat : 0.f;
      o[t] = in ? int(wf) * ch : -1;
      if (in) lo = min(lo, int(wf)), hi = max(hi, int(wf));
    }
    const __nv_bfloat162 h2 = __floats2bfloat162_rn(hb[0], hb[1]);
    // a NaN coordinate makes every tap NaN, as clip(NaN) does in the plain
    // version; ±inf reaches no tap (hat 0 everywhere)
    tap[m] = Tap{s != s ? s : 0.f, *reinterpret_cast<const uint32_t*>(&h2), o[0], o[1]};
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (tid % kWarp == 0) part_lo[tid / kWarp] = lo, part_hi[tid / kWarp] = hi;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kThreads / kWarp; ++a) lo = min(lo, part_lo[a]), hi = max(hi, part_hi[a]);
  const int span = hi >= lo ? (hi - lo + 1) * ch : 0;
  if (span == 0) lo = 0;  // no tap in the window: nothing is staged

  // 2. each band row's span [lo·ch, (hi + 1)·ch) into shared memory, at
  // row_phase + k for span element k: its 16-byte chunks land on 16 bytes
  const __nv_bfloat16* row0 = band_row0 + lo * ch;
  if (tid < R) row_phase[tid] = phase8(row0 + size_t(tid) * WF);
  const int chunks = (span + 14) >> 3;  // ≥ the chunks of any row's phase
  stage_rows(win, row0, WF, stride, span, chunks, R);
  __syncthreads();

  // 3. resample: a thread takes one column m (its taps read once) over
  // the band's rows, the ch values of (jj, m) into the band's output tile
  // at po + jj·lanes + m·ch + c: the tile is the output run, laid on the
  // output's 16-byte grid
  const int lanes = M * ch;
  const int total = R * lanes;
  __nv_bfloat16* run = out + (size_t(i) * rows + j0) * size_t(lanes);
  const int po = phase8(run);
  const int groups = M < kThreads ? kThreads / M : 1;  // row groups
  for (int u = tid; u < groups * M; u += kThreads) {
    const int g = u / M, m = u - g * M;
    const Tap t = tap[m];
    const float2 hb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.hats));
    for (int jj = g; jj < R; jj += groups) {
      const __nv_bfloat16* wrow = win + jj * stride + row_phase[jj] - lo * ch;
      __nv_bfloat16* dst = tile + po + jj * lanes + m * ch;
#pragma unroll
      for (int c = 0; c < ch; ++c) {
        float acc = t.base;
        if (t.o0 >= 0) acc = acc + hb.x * __bfloat162float(wrow[t.o0 + c]);
        if (t.o1 >= 0) acc = acc + hb.y * __bfloat162float(wrow[t.o1 + c]);
        dst[c] = __float2bfloat16_rn(acc);
      }
    }
  }
  __syncthreads();

  // 4. the run out in 8-value chunks: a whole chunk is one 16-byte store,
  // the run's head and tail chunks go element by element
  for (int q = tid; q < (po + total + 7) >> 3; q += kThreads) {
    const int e0 = 8 * q - po;  // run element of the chunk's first lane
    if (e0 >= 0 && e0 + 8 <= total) {
      *reinterpret_cast<uint4*>(run + e0) = *reinterpret_cast<const uint4*>(tile + 8 * q);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e0 + e >= 0 && e0 + e < total) run[e0 + e] = tile[8 * q + e];
    }
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
  using namespace mdcv::wr;
  if (B <= 0 || H <= 0 || WF <= 0 || rows <= 0 || M <= 0 || win_w <= 0 || ch <= 0 ||
      rows > H || win_w * ch > WF)
    return int(cudaErrorInvalidValue);
  if (n == 0) return 0;
  // a staged row holds a span of at most win_w·ch lanes after a phase of
  // at most 7, in whole 16-byte chunks
  const int stride = (win_w * ch + 7 + 7) / 8 * 8;
  const long long band_lanes = (long long)kBand * M * ch;
  const long long blocks = (long long)n * ((rows + kBand - 1) / kBand);
  if (band_lanes > kMaxSmem || blocks > INT_MAX || (long long)rows * M * ch > INT_MAX)
    return int(cudaErrorInvalidValue);
  const int tap_bytes = int((size_t(M) * sizeof(Tap) + 15) / 16 * 16);
  // the band's output run after a phase of at most 7, in whole chunks
  const int tile_bytes = int((band_lanes + 7 + 7) / 8 * 16);
  const size_t smem =
      size_t(tap_bytes) + tile_bytes + size_t(kBand) * stride * sizeof(__nv_bfloat16);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  auto kernel = ch == 1   ? window_resample_kernel<1>
                : ch == 3 ? window_resample_kernel<3>
                : ch == 4 ? window_resample_kernel<4>
                          : window_resample_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  kernel<<<int(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(frames), static_cast<const int*>(fidx),
      static_cast<const int*>(r0), static_cast<const int*>(l0), static_cast<const float*>(sx),
      static_cast<__nv_bfloat16*>(out), B, H, WF, rows, M, win_w, ch, stride, tap_bytes,
      tile_bytes);
  return int(cudaGetLastError());
}
