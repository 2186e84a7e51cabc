// K5 — a whole int8 Darknet residual stage: n × [1×1 C→C/2, 3×3 C/2→C,
// shortcut add], on zero-bordered NHWC activations.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_resstage.py:fused_res_stage (body _res_stage_kernel), which keeps
// a whole stage of G images in VMEM. One Hopper block cannot: one 26² image
// at C=512 is 28²·512 = 401 KB of int8 plus 803 KB of bf16 carrier,
// against 227 KB of shared memory. So the stage runs from device memory,
// and the host loops over its n residual blocks, two kernels each:
//
//   t   = q8(leaky(deq(1×1(q8(carrier, sx1[i])))), sx3[i])    conv1x1_kernel
//   res = bf16(leaky(deq(3×3(t))) + carrier)                   conv3x3_kernel
//   carrier = res; after the last block yq = q8(res, sx_out)
//
// with the rounding points of ops/resstage.py:res_stage_reference, its
// plain version, which this kernel equals bit for bit: int32 sums (__dp4a
// over channel quads); acc·scale then +b as two f32 roundings
// (-fmad=false, __fmul_rn / __fadd_rn); a bf16 cast; leaky comparing the
// f32 value and multiplying the bf16 one by the slope rounded to bf16;
// requant = clamp(rintf(x·sx_inv), ±127); the shortcut add in bf16 on a
// bf16 carrier that never goes through int8. The int8 t lives in device
// memory between the two kernels, in a zero-bordered (S+2)² layout, so the
// 3×3 reads its zero padding from the borders; borders of every output
// stay 0. The carrier of B=8 at 26² (6.4 MB) stays in the 50 MB L2.
//
// Each conv is an implicit GEMM, M = B·S² interior positions, N output
// channels, K = taps·Cin (tap-major, as the weights are packed once by
// ops/resstage.py:pack_res_stage): one block of 256 threads per 64×64
// output tile walks K in 32-byte chunks through shared memory, each thread
// owning a 4×4 micro-tile of int32 sums. Bound: operations — the int8 dot
// products, here on the CUDA cores (__dp4a); the tensor cores (wgmma) and
// TMA are later work.
#include "common.cuh"

namespace mdcv {
namespace rs {

constexpr int kBM = 64, kBN = 64;        // output tile: positions × channels
constexpr int kBK = 32;                  // bytes of K per chunk (8 int32 words)
constexpr int kBKW = kBK / 4;
constexpr int kLd = kBKW + 1;            // padded row of a shared tile, in words
constexpr int kThreads = 256;

__device__ __forceinline__ int8_t q8(float v, float sx_inv) {
  const float r = rintf(__fmul_rn(v, sx_inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// int32 → acc·scale + b in f32 → bf16 → leaky (slope already in bf16)
__device__ __forceinline__ __nv_bfloat16 deq_leaky(int acc, float scale, float bias,
                                                   float slope) {
  const float y32 = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  const __nv_bfloat16 y = __float2bfloat16_rn(y32);
  return y32 >= 0.f ? y : __float2bfloat16_rn(__fmul_rn(__bfloat162float(y), slope));
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return int(uint8_t(a)) | (int(uint8_t(b)) << 8) | (int(uint8_t(c)) << 16) |
         (int(uint8_t(d)) << 24);
}

// zero-bordered flat index of interior position m = (img, y, x) of an S×S map
__device__ __forceinline__ size_t padded_pos(int m, int S) {
  const int img = m / (S * S), r = m % (S * S);
  return (size_t(img) * (S + 2) + r / S + 1) * (S + 2) + r % S + 1;
}

// One K chunk of the 64×64 tile: sums += A[64 rows][8 words] · B[64 cols][8 words].
__device__ __forceinline__ void mma_chunk(int (*sA)[kLd], int (*sB)[kLd],
                                          int ty, int tx, int acc[4][4]) {
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
}

// B tile: 64 output channels × 32 bytes of row-major (N, K) int8 weights;
// threads 128..255 load one 16-byte half row each (zeros past N).
__device__ __forceinline__ void load_weights(int (*sB)[kLd], const int8_t* __restrict__ w,
                                             int n0, int N, int K, int k0) {
  const int t = threadIdx.x - 128, col = t / 2, half = t % 2;
  int4 v = make_int4(0, 0, 0, 0);
  if (n0 + col < N)
    v = *reinterpret_cast<const int4*>(w + size_t(n0 + col) * K + k0 + half * 16);
  int* dst = sB[col] + half * 4;
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// 1×1 C→Cm on the bf16 carrier, quantized on load with sx1; writes
// tq = q8(leaky(deq(acc)), sx3) at the interior of the zero-bordered t.
__global__ void __launch_bounds__(kThreads)
    conv1x1_kernel(const __nv_bfloat16* __restrict__ carrier, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ sx1, const float* __restrict__ sx3,
                   int8_t* __restrict__ tq, int M, int S, int C, int Cm, float slope) {
  __shared__ int sA[kBM][kLd];
  __shared__ int sB[kBN][kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const float s_in = *sx1;
  // loader rows (threads 0..127): position m0 + tid/2, channels half·16..+16
  const int lrow = tid / 2, lhalf = tid % 2;
  const bool lvalid = tid < 128 && m0 + lrow < M;
  const size_t lpos = lvalid ? padded_pos(m0 + lrow, S) : 0;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kBK) {
    if (tid < 128) {
      int words[4] = {0, 0, 0, 0};
      if (lvalid) {
        const int4* src =
            reinterpret_cast<const int4*>(carrier + lpos * C + k0 + lhalf * 16);
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
      load_weights(sB, w, n0, Cm, C, k0);
    }
    __syncthreads();
    mma_chunk(sA, sB, ty, tx, acc);
    __syncthreads();
  }

  const float s_out = *sx3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    int8_t* dst = tq + padded_pos(m, S) * Cm;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cm)
        dst[n] = q8(__bfloat162float(deq_leaky(acc[i][j], scale[n], bias[n], slope)), s_out);
    }
  }
}

// 3×3 Cm→C on the zero-bordered tq, then the shortcut: carrier ←
// bf16(leaky(deq(acc)) + carrier) in place; with yq non-null (the last
// block) also yq = q8(carrier, sx_out).
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const int8_t* __restrict__ tq, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ carrier, const float* __restrict__ sx_out,
                   int8_t* __restrict__ yq, int M, int S, int Cm, int C, float slope) {
  __shared__ int sA[kBM][kLd];
  __shared__ int sB[kBN][kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int W = S + 2;
  const int lrow = tid / 2, lhalf = tid % 2;
  const bool lvalid = tid < 128 && m0 + lrow < M;
  // tap (dy, dx) of interior (y, x) reads the padded t at (y + dy, x + dx)
  size_t lbase = 0;
  if (lvalid) {
    const int m = m0 + lrow, img = m / (S * S), r = m % (S * S);
    lbase = (size_t(img) * W + r / S) * W + r % S;
  }
  const int K = 9 * Cm;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (tid < 128) {
      int4 v = make_int4(0, 0, 0, 0);
      if (lvalid) {
        const int tap = k0 / Cm, c0 = k0 % Cm;
        const size_t pos = lbase + (tap / 3) * W + tap % 3;
        v = *reinterpret_cast<const int4*>(tq + pos * Cm + c0 + lhalf * 16);
      }
      int* dst = sA[lrow] + lhalf * 4;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    } else {
      load_weights(sB, w, n0, C, K, k0);
    }
    __syncthreads();
    mma_chunk(sA, sB, ty, tx, acc);
    __syncthreads();
  }

  const float s_out = yq ? *sx_out : 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const size_t pos = padded_pos(m, S) * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= C) continue;
      const float y = __bfloat162float(deq_leaky(acc[i][j], scale[n], bias[n], slope));
      const __nv_bfloat16 res = __float2bfloat16_rn(y + __bfloat162float(carrier[pos + n]));
      carrier[pos + n] = res;
      if (yq) yq[pos + n] = q8(__bfloat162float(res), s_out);
    }
  }
}

// carrier ← x with its borders zeroed (the stage reads only interiors)
__global__ void carrier_init_kernel(const __nv_bfloat16* __restrict__ x,
                                    __nv_bfloat16* __restrict__ carrier, size_t total, int S,
                                    int C) {
  const int W = S + 2;
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < total;
       i += size_t(gridDim.x) * blockDim.x) {
    const size_t pos = i / C;
    const int x_ = int(pos % W), y_ = int((pos / W) % W);
    const bool inside = y_ >= 1 && y_ <= S && x_ >= 1 && x_ <= S;
    carrier[i] = inside ? x[i] : __float2bfloat16_rn(0.f);
  }
}

}  // namespace rs
}  // namespace mdcv

// The whole stage: x (B, S+2, S+2, C) bf16 → ybf (the same, the bf16 stage
// output) and yq (B, S+2, S+2, C) int8, both zero-bordered; tq is scratch of
// (B, S+2, S+2, C/2) int8. Weights of block i: w1 + i·(C/2)·C (row-major
// (C/2, C)), w3 + i·C·9·(C/2) (row-major (C, 9·C/2), tap-major K); scales
// and biases s1, b1 (n, C/2), s3, b3 (n, C); sx1, sx3 (n,), sx_out (1,).
extern "C" int mdcv_res_stage(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w3, const void* s3, const void* b3, const void* sx1,
                              const void* sx3, const void* sx_out, void* ybf, void* yq,
                              void* tq, int B, int S, int C, int n_blocks, float slope,
                              int dtype, void* stream) {
  using namespace mdcv::rs;
  if (dtype != 1 || S <= 0 || C % 64 || n_blocks <= 0) return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int Cm = C / 2, M = B * S * S;
  const size_t padded = size_t(B) * (S + 2) * (S + 2);
  const size_t total = padded * C;
  const int init_blocks = int((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  carrier_init_kernel<<<init_blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                                   static_cast<__nv_bfloat16*>(ybf), total, S, C);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  if ((e = cudaMemsetAsync(tq, 0, padded * Cm, st)) != cudaSuccess) return int(e);
  if ((e = cudaMemsetAsync(yq, 0, padded * C, st)) != cudaSuccess) return int(e);

  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto i8 = [](const void* p) { return static_cast<const int8_t*>(p); };
  const dim3 grid1((M + kBM - 1) / kBM, (Cm + kBN - 1) / kBN);
  const dim3 grid3((M + kBM - 1) / kBM, (C + kBN - 1) / kBN);
  for (int i = 0; i < n_blocks; ++i) {
    conv1x1_kernel<<<grid1, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(ybf), i8(w1) + size_t(i) * Cm * C,
        f32(s1) + size_t(i) * Cm, f32(b1) + size_t(i) * Cm, f32(sx1) + i, f32(sx3) + i,
        static_cast<int8_t*>(tq), M, S, C, Cm, slope);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    conv3x3_kernel<<<grid3, kThreads, 0, st>>>(
        static_cast<const int8_t*>(tq), i8(w3) + size_t(i) * C * 9 * Cm,
        f32(s3) + size_t(i) * C, f32(b3) + size_t(i) * C, static_cast<__nv_bfloat16*>(ybf),
        f32(sx_out), i == n_blocks - 1 ? static_cast<int8_t*>(yq) : nullptr, M, S, Cm, C,
        slope);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}
