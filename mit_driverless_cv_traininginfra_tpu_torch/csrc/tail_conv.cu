// tail_conv — RektNet's res4.conv1 in int8: quantize a bf16 NHWC crop on
// load, 3×3 convolution with dilation 2 and zero padding 2 (the output keeps
// the crop's 80×80), int32 sums, acc·scale then +bias in f32, bf16, relu.
//
// Replaces the TPU probe tools/probe_tail_conv1.py:tail_conv1 (its
// pallas_call at :64), which runs one crop per program in a flat "pair"
// layout (two pixels per 128-lane row, rows padded to 42 pairs) with an
// in-VMEM im2col of K = 576 per half. That layout was the TPU's lane rule;
// here input and output are plain NHWC and the kernel is an implicit GEMM
// on the int8 tensor cores: M = crops·80·80 positions, N = 128 output
// channels, K = 9·64 taps-major (the layout of ``wq.reshape(576, 128)``
// and of models/quantize.py:_im2col). The served width is Cin 64 → N 128;
// the tiny RektNet (net_size 8) has 32 → 64, built from the same template.
//
// Rounding points of the plain version ``F.relu(_qconv(h, q))``
// (ops/tail_conv.py): requant = clamp(rintf(x·sx_inv), ±127) on load, int32
// sums (exact in any order: 576·127² < 2³¹), acc·scale then +b as two f32
// roundings (-fmad=false, __fmul_rn / __fadd_rn), one bf16 cast, relu on
// the bf16 value. Equal to it value for value.
//
// Bound: bytes — the bf16 input read once and the bf16 output written
// once (157 MB at 64 crops, 0.047 ms at 3.35 TB/s) against 60 GOP of int8
// products (0.031 ms at 1,979 TOP/s). The design:
//
// - a persistent block of 256 threads per SM walks the (crop, band of 4
//   output rows) tiles; it loads the weights once, as wgmma B tiles
//   (K-major 8×16-byte core matrices) that ops/tail_conv.py:pack_tail_conv
//   lays out on the host (ops/entry.py:_pack_wgmma; 72 KB), and keeps them
//   in shared memory;
// - a tile's input window (its 4 rows + 2·2 halo rows, all 80 columns, all
//   channels) lands as raw bf16 by cp.async, issued while the previous
//   tile computes; the block then quantizes it once into an int8 window
//   of 84 columns whose two zero columns each side are the padding (rows
//   outside the crop are zero-filled by the copy), 16-byte chunks
//   XOR-swizzled so that ldmatrix's eight rows fall in eight bank groups;
// - the 9 taps read that window at address offsets: warpgroup h takes
//   channels 64h … 64h + 63, its warp oy output row oy of the band; per
//   tap, each warp loads its 5 m-tiles' A fragments by ldmatrix and the
//   warpgroup issues wgmma.m64n64k32 s8 for each m-tile (the 4 rows'
//   m-tile mi is one m64), B read by descriptor; 160 sums a thread;
// - the epilogue rounds two columns at a time (relu in f32, then one
//   packed bf16 cast: the same values), transposes each quad's C fragments
//   (quad_transpose) so that a lane holds eight consecutive channels, and
//   stores 16 bytes.
//
// Why: tools/mma_rates.py measures mma.sync at about two thirds of
// wgmma's int8 rate on an H100; in a first design on mma.sync a tile's
// products, epilogue and requant each took a large share of its cycles
// (clock64 phases of a patched copy), and the conversion instructions of
// rintf / float→int run at a quarter of the ALU rate, which q8_bits avoids.
// 10 warps of 4 m-tiles spilled: three warps a sub-partition cap a thread
// at 168 registers.
//
// Shared memory at Cin 64: weights 72 KB, raw window 80 KB, int8 window
// 42 KB, scales and biases 1 KB: 195 KB of 227. One launch a call.
#include <atomic>

#include "int8_mma.cuh"

namespace mdcv {
namespace tc {

constexpr int kH = 80, kW = 80;                 // the crop
constexpr int kDil = 2;                         // dilation, and padding
constexpr int kBand = 4;                        // output rows a tile
constexpr int kWinRows = kBand + 2 * kDil;      // 8
constexpr int kWinCols = kW + 2 * kDil;         // 84: 2 zero columns each side
constexpr int kBands = kH / kBand;              // 20 tiles a crop
constexpr int kMT = kW / 16;                    // a warp's m-tiles: one output row
static_assert(kH % kBand == 0 && kW % 16 == 0, "tiles cover the crop");

template <int kCin, int kN>
struct Cfg {
  static constexpr int kK = 9 * kCin;
  static constexpr int kHalves = kCin / 32;             // k-steps a tap
  static constexpr int kGroups = kN / 32;               // 32-column B tiles
  static constexpr int kNH = kN / 64;                   // warpgroups, 64 columns each
  static constexpr int kWarps = kBand * kNH;            // a warp an output row
  static constexpr int kThreads = kWarps * kWarp;
  static constexpr int kWBytes = kK * kN;
  static constexpr int kRawBytes = kWinRows * kW * kCin * 2;
  static constexpr int kWinBytes = kWinRows * kWinCols * kCin;
  static constexpr int kOffRaw = kWBytes;
  static constexpr int kOffWin = kOffRaw + kRawBytes;
  static constexpr int kOffPar = kOffWin + kWinBytes;
  static constexpr int kSmem = kOffPar + 2 * kN * 4;
  static_assert(kCin % 32 == 0 && kN % 64 == 0, "whole k-steps and jobs");
  static_assert(kOffRaw % 16 == 0 && kOffWin % 16 == 0 && kOffPar % 16 == 0, "alignment");
  static_assert(kSmem <= 232448, "shared memory");
};

// the 16-byte chunk c of window position pos, swizzled: the eight rows of
// an ldmatrix 8×8 matrix are eight consecutive positions, which this
// spreads over the eight bank groups from any first position
template <int kCin>
__device__ __forceinline__ int swz(int pos, int c) {
  return kCin == 64 ? c ^ ((pos >> 1) & 3) : c ^ ((pos >> 2) & 1);
}

// raw window of tile (crop, band): rows band·4 − 2 .. +7 of the crop, all
// columns and channels, bf16 as stored; rows outside the crop are zeros
template <int kCin, int kThreads>
__device__ __forceinline__ void load_raw(const __nv_bfloat16* __restrict__ x, unsigned char* raw,
                                         int tile) {
  constexpr int kPieces = kCin / 8;  // 16-byte pieces a position
  const int crop = tile / kBands, y0 = (tile % kBands) * kBand - kDil;
  for (int i = threadIdx.x; i < kWinRows * kW * kPieces; i += kThreads) {
    const int wy = i / (kW * kPieces), rem = i % (kW * kPieces);
    const int y = y0 + wy;
    const bool in = y >= 0 && y < kH;
    const __nv_bfloat16* src =
        in ? x + ((size_t(crop) * kH + y) * kW + rem / kPieces) * kCin + (rem % kPieces) * 8 : x;
    cp_async16(raw + size_t(i) * 16, src, in ? 16 : 0);
  }
}

// two columns: acc·scale + b in f32 (two roundings), relu, one bf16 cast
// each — relu before the cast equals relu after it, +0 for every y ≤ 0 —
// as a bf16 pair
__device__ __forceinline__ uint32_t deq_relu2(int a0, int a1, float2 scale, float2 bias) {
  float y0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), scale.x), bias.x);
  float y1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), scale.y), bias.y);
  y0 = y0 > 0.f ? y0 : 0.f;
  y1 = y1 > 0.f ? y1 : 0.f;
  const __nv_bfloat162 r = __floats2bfloat162_rn(y0, y1);
  return *reinterpret_cast<const uint32_t*>(&r);
}

template <int kCin, int kN>
__global__ void __launch_bounds__(Cfg<kCin, kN>::kThreads, 1)
    tail_conv_kernel(const __nv_bfloat16* __restrict__ x, const int4* __restrict__ wtiles,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ sx_inv, __nv_bfloat16* __restrict__ out,
                     int tiles) {
  using G = Cfg<kCin, kN>;
  constexpr int kPieces = kCin / 8, kThreads = G::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw = smem + G::kOffRaw;
  int8_t* win = reinterpret_cast<int8_t*>(smem + G::kOffWin);
  float* par = reinterpret_cast<float*>(smem + G::kOffPar);  // scales, then biases

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int h = warp / kBand, oy = warp % kBand;  // warpgroup h, output row oy
  const float s_in = *sx_inv;

  for (int i = tid; i < G::kWBytes / 16; i += kThreads) cp_async16(smem + i * 16, wtiles + i, 16);
  for (int i = tid; i < kN; i += kThreads) par[i] = scale[i], par[kN + i] = bias[i];
  // the padding columns of the int8 window: zero for good
  for (int i = tid; i < kWinRows * 2 * kDil * (kCin / 16); i += kThreads) {
    const int p = i / (kCin / 16), col = p % (2 * kDil);
    const int pos = (p / (2 * kDil)) * kWinCols + (col < kDil ? col : kWinCols - 2 * kDil + col);
    reinterpret_cast<int4*>(win + pos * kCin)[i % (kCin / 16)] = make_int4(0, 0, 0, 0);
  }
  if (blockIdx.x < tiles) load_raw<kCin, kThreads>(x, raw, blockIdx.x);
  cp_async_commit();

  // this lane's ldmatrix row of m-tile 0 (columns 0..15 of row oy), as a
  // window position at tap (0, 0); m-tile mi is 16·mi further
  const int base = oy * kWinCols + arow;
  const uint32_t win_u32 = smem_u32(win);

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    cp_async_wait<0>();   // this tile's raw window (and, first, the weights) landed
    fence_proxy_async();  // the weights, copied by cp.async, are read by wgmma
    __syncthreads();      // ... for every thread; and the last tile's products are done
#pragma unroll 4
    for (int i = tid; i < kWinRows * kW * kPieces; i += kThreads) {
      const uint4 v = reinterpret_cast<const uint4*>(raw)[i];
      const __nv_bfloat16* hv = reinterpret_cast<const __nv_bfloat16*>(&v);
      uint32_t qb[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) qb[e] = q8_bits(__bfloat162float(hv[e]), s_in);
      const int wy = i / (kW * kPieces), rem = i % (kW * kPieces);
      const int pos = wy * kWinCols + rem / kPieces + kDil, c = (rem % kPieces) * 8;
      *reinterpret_cast<uint2*>(win + pos * kCin + (swz<kCin>(pos, c >> 4) << 4) + (c & 15)) =
          make_uint2(pack_q8(qb[0], qb[1], qb[2], qb[3]), pack_q8(qb[4], qb[5], qb[6], qb[7]));
    }
    __syncthreads();  // the int8 window is whole; the raw buffer is free
    if (t + gridDim.x < tiles) load_raw<kCin, kThreads>(x, raw, t + gridDim.x);
    cp_async_commit();

    // warpgroup h: channels 64h..; warp oy: output row oy, 5 m-tiles of 16
    // positions; wgmma mi multiplies the 4 rows' m-tile mi (m64) by 64 channels
    int d[kMT][32];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int i = 0; i < 32; ++i) d[mi][i] = 0;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * kDil * kWinCols + (tap % 3) * kDil;
      uint32_t a[G::kHalves][kMT][4];
#pragma unroll
      for (int kh = 0; kh < G::kHalves; ++kh)
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const int pos = base + 16 * mi + toff;
          ldmatrix_x4(win_u32 + pos * kCin + (swz<kCin>(pos, kh * 2 + ahalf) << 4), a[kh][mi]);
        }
      wgmma_fence();
#pragma unroll
      for (int kh = 0; kh < G::kHalves; ++kh) {
        const uint64_t desc =
            kmajor_desc(smem + ((tap * G::kHalves + kh) * G::kGroups + 2 * h) * 1024);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) wgmma_n64(d[mi], a[kh][mi], desc);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int kh = 0; kh < G::kHalves; ++kh)
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
          for (int e = 0; e < 4; ++e) keep(a[kh][mi][e]);
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(d[mi][i]);
    }

    // epilogue: n-tile nt's columns 64h + 8nt + 2t4, +1 of rows g, g + 8
    const int crop = t / kBands, y0 = (t % kBands) * kBand;
    float2 sc[8], bi[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt] = *reinterpret_cast<const float2*>(par + 64 * h + 8 * nt + 2 * t4);
      bi[nt] = *reinterpret_cast<const float2*>(par + kN + 64 * h + 8 * nt + 2 * t4);
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int xo = 16 * mi + g + 8 * rr;
        __nv_bfloat16* orow = out + ((size_t(crop) * kH + y0 + oy) * kW + xo) * kN + 64 * h;
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int nt = 4 * grp + j;
            v[j] = deq_relu2(d[mi][4 * nt + 2 * rr], d[mi][4 * nt + 2 * rr + 1], sc[nt], bi[nt]);
          }
          quad_transpose(v, t4);  // → n-tile 4grp + t4, its 8 columns in order
          *reinterpret_cast<uint4*>(orow + 8 * (4 * grp + t4)) = make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }
  }
}

template <int kCin, int kN>
int launch(const void* x, const void* wtiles, const void* scale, const void* bias,
           const void* sx_inv, void* out, int tiles, int n_sm, bool opt_in,
           cudaStream_t stream) {
  using G = Cfg<kCin, kN>;
  if (opt_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        tail_conv_kernel<kCin, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (e != cudaSuccess) return int(e);
  }
  const int grid = tiles < n_sm ? tiles : n_sm;
  tail_conv_kernel<kCin, kN><<<grid, G::kThreads, G::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int4*>(wtiles),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(sx_inv), static_cast<__nv_bfloat16*>(out), tiles);
  return int(cudaGetLastError());
}

}  // namespace tc
}  // namespace mdcv

// x (C, 80, 80, Cin) bf16 NHWC → out (C, 80, 80, N) bf16; wtiles: the
// (9·Cin, N) weights as ops/tail_conv.py:pack_tail_conv lays them out
// ((9·Cin/32, N/32, 4, 2, 8, 16) int8 wgmma tiles); scale, bias (N,) f32;
// sx_inv (1,) f32. Takes (Cin, N) = (64, 128) or (32, 64), dilation 2.
extern "C" int mdcv_tail_conv(const void* x, const void* wtiles, const void* scale,
                              const void* bias, const void* sx_inv, void* out, int C, int H,
                              int W, int Cin, int N, int dil, int dtype, void* stream) {
  using namespace mdcv::tc;
  if (dtype != 1 || H != kH || W != kW || dil != kDil || C < 0) return int(cudaErrorInvalidValue);
  const bool wide = Cin == 64 && N == 128, narrow = Cin == 32 && N == 64;
  if (!wide && !narrow) return int(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const long long tiles = (long long)C * kBands;
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  // the dynamic shared memory opt-in of each width and the SM count, once
  // per device (kept here, not in the template: a function-local static of
  // a template is one symbol across every library loaded in the process)
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
  static std::atomic<bool> opted[2][kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  int n_sm = sms[dev].load(std::memory_order_acquire);
  if (n_sm == 0) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    sms[dev].store(n_sm, std::memory_order_release);
  }
  const bool opt_in = !opted[wide][dev].load(std::memory_order_acquire);
  auto st = static_cast<cudaStream_t>(stream);
  const int rc =
      wide ? launch<64, 128>(x, wtiles, scale, bias, sx_inv, out, int(tiles), n_sm, opt_in, st)
           : launch<32, 64>(x, wtiles, scale, bias, sx_inv, out, int(tiles), n_sm, opt_in, st);
  if (rc == 0 && opt_in) opted[wide][dev].store(true, std::memory_order_release);
  return rc;
}
