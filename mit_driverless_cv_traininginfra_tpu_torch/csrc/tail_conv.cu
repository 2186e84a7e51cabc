// tail_conv — RektNet's res4.conv1 in int8: quantize a bf16 NHWC input on
// load, 3×3 convolution with dilation d and zero padding d (the output keeps
// the input's H×W), int32 sums, acc·scale then +bias in f32, bf16, relu.
//
// Replaces the TPU probe tools/probe_tail_conv1.py:tail_conv1 (its
// pallas_call at :64), which runs one crop per program in a flat "pair"
// layout (two pixels per 128-lane row, rows padded to 42 pairs) with an
// in-VMEM im2col of K = 576 per half. That layout was the TPU's lane rule;
// here input and output are plain NHWC and the kernel is an implicit GEMM:
// M = C·H·W positions, N output channels, K = 9·Cin, taps outer in (dy, dx)
// order and channels inner (the layout of ``wq.reshape(576, 128)`` and of
// models/quantize.py:_im2col). Padding is read from coordinates, so nothing
// is materialised around the crop.
//
// Rounding points of the plain version ``F.relu(_qconv(h, q))``
// (ops/tail_conv.py): requant = clamp(rintf(x·sx_inv), ±127) on load, int32
// sums (__dp4a over channel quads), acc·scale then +b as two f32 roundings
// (-fmad=false, __fmul_rn / __fadd_rn), one bf16 cast, relu on the bf16
// value. Equal to it value for value.
//
// One block of 256 threads per 64×64 output tile (K5's pattern,
// csrc/res_stage.cu): threads 0..127 quantize 16 channels of one tap of one
// position each into shared memory, threads 128..255 load 16 bytes of a
// weight row; K walks in 32-byte chunks (Cin a multiple of 32, so a chunk
// never straddles two taps); each thread owns a 4×4 micro-tile of sums.
// Bound: operations — the int8 dot products, here on the CUDA cores
// (__dp4a); the tensor cores (mma.sync / wgmma) are later work.
#include "common.cuh"

namespace mdcv {
namespace tc {

constexpr int kBM = 64, kBN = 64;  // output tile: positions × channels
constexpr int kBK = 32;            // bytes of K per chunk (8 int32 words)
constexpr int kBKW = kBK / 4;
constexpr int kLd = kBKW + 1;      // padded row of a shared tile, in words
constexpr int kThreads = 256;

__device__ __forceinline__ int8_t q8(float v, float sx_inv) {
  const float r = rintf(__fmul_rn(v, sx_inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return int(uint8_t(a)) | (int(uint8_t(b)) << 8) | (int(uint8_t(c)) << 16) |
         (int(uint8_t(d)) << 24);
}

__global__ void __launch_bounds__(kThreads)
    tail_conv_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     const float* __restrict__ sx_inv, __nv_bfloat16* __restrict__ out,
                     int M, int H, int W, int Cin, int N, int dil) {
  __shared__ int sA[kBM][kLd];
  __shared__ int sB[kBN][kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float s_in = *sx_inv;
  const int K = 9 * Cin;
  // loader rows (threads 0..127): position m0 + tid/2, channels half·16..+16
  const int lrow = tid / 2, lhalf = tid % 2;
  const bool lvalid = tid < 128 && m0 + lrow < M;
  int img = 0, py = 0, px = 0;
  if (lvalid) {
    const int m = m0 + lrow, r = m % (H * W);
    img = m / (H * W);
    py = r / W;
    px = r % W;
  }

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (tid < 128) {
      int words[4] = {0, 0, 0, 0};
      const int tap = k0 / Cin, c0 = k0 % Cin;
      const int yy = py + dil * (tap / 3 - 1), xx = px + dil * (tap % 3 - 1);
      if (lvalid && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const size_t pos = (size_t(img) * H + yy) * W + xx;
        const int4* src = reinterpret_cast<const int4*>(x + pos * Cin + c0 + lhalf * 16);
        const int4 raw[2] = {src[0], src[1]};
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          words[q] = pack4(q8(__bfloat162float(h[4 * q]), s_in),
                           q8(__bfloat162float(h[4 * q + 1]), s_in),
                           q8(__bfloat162float(h[4 * q + 2]), s_in),
                           q8(__bfloat162float(h[4 * q + 3]), s_in));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sA[lrow][lhalf * 4 + q] = words[q];
    } else {
      // B tile: 64 output channels × 32 bytes of the row-major (N, K) weights
      const int t = tid - 128, col = t / 2, half = t % 2;
      int4 v = make_int4(0, 0, 0, 0);
      if (n0 + col < N)
        v = *reinterpret_cast<const int4*>(w + size_t(n0 + col) * K + k0 + half * 16);
      int* dst = sB[col] + half * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKW; ++k) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float y32 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[n]), bias[n]);
      const __nv_bfloat16 y = __float2bfloat16_rn(y32);
      out[size_t(m) * N + n] = __bfloat162float(y) > 0.f ? y : __float2bfloat16_rn(0.f);
    }
  }
}

}  // namespace tc
}  // namespace mdcv

// x (C, H, W, Cin) bf16 NHWC → out (C, H, W, N) bf16; w_nk row-major
// (N, 9·Cin) int8 with K tap-major; scale, bias (N,) f32; sx_inv (1,) f32.
extern "C" int mdcv_tail_conv(const void* x, const void* w_nk, const void* scale,
                              const void* bias, const void* sx_inv, void* out, int C, int H,
                              int W, int Cin, int N, int dil, int dtype, void* stream) {
  using namespace mdcv::tc;
  if (dtype != 1 || Cin % 32 || N <= 0 || dil <= 0 || H <= 0 || W <= 0)
    return int(cudaErrorInvalidValue);
  if (C == 0) return 0;
  const long long M = (long long)C * H * W;
  if (M > 0x7fffffffLL - kBM) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned((M + kBM - 1) / kBM), unsigned((N + kBN - 1) / kBN));
  tail_conv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_nk),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(sx_inv), static_cast<__nv_bfloat16*>(out), int(M), H, W, Cin,
      N, dil);
  return int(cudaGetLastError());
}
