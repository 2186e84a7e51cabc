// int8_contract — a strided int8 contraction into int32:
//
//   out[m·som + n·son] = Σ_k A[m·sam + k·sak] · B[k·sbk + n·sbn]
//
// with an optional epilogue bf16(f32(acc) · scale[n]) (strides in elements).
//
// Replaces the TPU probes' int8 dot_generals: tools/probe_mosaic.py:48, :118,
// :145 (P1, P5, P7 with its epilogue), probe_mosaic2.py:105, :120 (P10,
// P11), probe_mosaic3.py:84 (P13), probe_mosaic4.py:70, :86 (P13b, P13c),
// probe_mosaic6.py:114 (P16) and tools/reprobe.py:89 (its two rank-3
// contractions). Each contracts one dimension of an int8 array against an
// int8 matrix; every probe's free dimensions are one contiguous flattening,
// so a flat m with one stride covers the contractions over dim 0 and over
// the minor dim alike, and the TPU's (8, 128) layout questions vanish.
//
// One block of 256 threads per 64×64 output tile; K walks in 32-byte chunks
// through shared memory, zero past K (K a multiple of 4: 16, 32, 48, 64,
// 108 in the probes); each thread gathers 8 bytes of A and 8 of B per chunk
// through the strides, packs them into words, and owns a 4×4 micro-tile of
// __dp4a sums (K5's inner loop, csrc/res_stage.cu). Sums are exact, so the
// result equals the plain version (ops/int8_contract.py) bit for bit. Bound:
// operations (2·M·N·K int8) — on the CUDA cores here; the tensor cores are
// later work.
#include "common.cuh"

namespace mdcv {
namespace ic {

constexpr int kBM = 64, kBN = 64;
constexpr int kBK = 32;  // bytes of K per chunk
constexpr int kBKW = kBK / 4;
constexpr int kLd = kBKW + 1;
constexpr int kThreads = 256;

struct Strides {
  long long sam, sak, sbk, sbn, som, son;
};

__device__ __forceinline__ int pack4(const int8_t* v) {
  return int(uint8_t(v[0])) | (int(uint8_t(v[1])) << 8) | (int(uint8_t(v[2])) << 16) |
         (int(uint8_t(v[3])) << 24);
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kThreads)
    int8_contract_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                         const float* __restrict__ scale, void* __restrict__ out, int M,
                         int N, int K, Strides s) {
  __shared__ int sA[kBM][kLd];
  __shared__ int sB[kBN][kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  // loader: row (of A) / column (of B) tid/4, 8 bytes of K at (tid%4)·8
  const int lr = tid / 4, lk = (tid % 4) * 8;
  const bool a_ok = m0 + lr < M, b_ok = n0 + lr < N;
  const int8_t* a_row = a + (long long)(m0 + lr) * s.sam;
  const int8_t* b_col = b + (long long)(n0 + lr) * s.sbn;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    int8_t va[8], vb[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int k = k0 + lk + u;
      va[u] = a_ok && k < K ? a_row[k * s.sak] : int8_t(0);
      vb[u] = b_ok && k < K ? b_col[k * s.sbk] : int8_t(0);
    }
    sA[lr][lk / 4] = pack4(va);
    sA[lr][lk / 4 + 1] = pack4(va + 4);
    sB[lr][lk / 4] = pack4(vb);
    sB[lr][lk / 4 + 1] = pack4(vb + 4);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBKW; ++k) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sA[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sB[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
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
      const long long o = m * s.som + n * s.son;
      if (kBf16Out)
        static_cast<__nv_bfloat16*>(out)[o] =
            __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[i][j]), scale[n]));
      else
        static_cast<int*>(out)[o] = acc[i][j];
    }
  }
}

}  // namespace ic
}  // namespace mdcv

// a, b int8 (strided views, element strides); scale (N,) f32 or null;
// out int32 (out_dtype 3) or, with scale, bf16 (out_dtype 1).
extern "C" int mdcv_int8_contract(const void* a, const void* b, const void* scale, void* out,
                                  int M, int N, int K, long long sam, long long sak,
                                  long long sbk, long long sbn, long long som, long long son,
                                  int out_dtype, void* stream) {
  using namespace mdcv::ic;
  const bool bf16 = out_dtype == 1;
  if (M < 0 || N < 0 || K <= 0 || (bf16 != (scale != nullptr)) ||
      (out_dtype != 1 && out_dtype != 3))
    return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  const Strides s{sam, sak, sbk, sbn, som, son};
  auto st = static_cast<cudaStream_t>(stream);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  const float* ps = static_cast<const float*>(scale);
  if (bf16)
    int8_contract_kernel<true><<<grid, kThreads, 0, st>>>(pa, pb, ps, out, M, N, K, s);
  else
    int8_contract_kernel<false><<<grid, kThreads, 0, st>>>(pa, pb, ps, out, M, N, K, s);
  return int(cudaGetLastError());
}
