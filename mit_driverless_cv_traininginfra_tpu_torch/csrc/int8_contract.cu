// int8_contract — a strided int8 contraction into int32:
//
//   out[m, n] = Σ_k A[m·sam + k·sak] · B[k·sbk + n·sbn]
//
// with an optional epilogue bf16(f32(acc) · scale[n]) (strides in elements;
// out row-major (M, N)).
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
// Bound: bytes. K ≤ 108 and N ≤ 208 in the probes, so a product does ≤ 2·K
// operations per output value against 4 bytes of int32 written: P16 at
// 128× its rows (M = 425,984, K = 108, N = 128) writes 218 MB of int32 and
// reads 46 MB of A, 0.0788 ms at 3.35 TB/s, against 0.006 ms of int8
// tensor-core work. The design streams the bytes (2.4 TB/s measured there,
// PERF.md §6):
//
// - Products on mma.sync.m16n8k32 s8 (int8_mma.cuh), A and B fragments by
//   ldmatrix from shared memory laid out K-contiguous, a row of kc = 32,
//   64 or 128 bytes (KS = 1, 2, 4 k-steps) with the 16-byte chunks of each
//   128-byte line XORed by the line's index (swz): conflict-free ldmatrix
//   for every kc. K is zero-padded to a multiple of kc (P16: 108 → 128).
// - A block owns a column tile of BN = 128 columns (N > 64) or 64 and
//   stages all of it once (every K chunk), while its first A tile is in
//   flight, then walks M tiles of BM rows with a stride of the grid, two A
//   buffers: the next (tile, chunk) is in flight while this one is
//   multiplied and stored. BM is 128 where that gives every SM a block
//   (P16×128: 3328 tiles, two blocks an SM), else 64 or 32, its 8 warps
//   then split the columns too: a small M (P1: 3536 rows) gets 111 blocks,
//   not 28, each with one staging and one epilogue on its critical path.
// - How an operand reaches shared memory is decided once per launch from
//   its strides and base (ops/int8_contract.py:staging_modes): rows with
//   unit k stride by cp.async of 16 bytes (base and row stride 16-aligned)
//   or 4 bytes (4-aligned: P16's 108-byte rows); rows with unit row stride
//   (A column-major: P10, P13, P13b, P13c, rank3_dim0; B N-major: every
//   probe) as 4-byte words of 4 consecutive rows at one k, four of them
//   transposed bytewise in registers (__byte_perm) into 4 rows × 4 k; any
//   other view byte by byte. Zeros past K and past the last row.
// - The epilogue goes through shared memory, a warp's 16 rows × 32
//   columns at a time, so that each row leaves as 16-byte stores of whole
//   32-byte sectors (the C fragment gives a thread 8 bytes of a row).
//   bf16: __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale[n])).
//
// Sums are exact, so the result equals the plain version
// (ops/int8_contract.py) bit for bit; tests/test_torch_int8_contract.py
// models the staging, the swizzle and the fragment order in numpy.
#include <algorithm>
#include <atomic>

#include "int8_mma.cuh"

namespace mdcv {
namespace ic {

constexpr int kThreads = 256;  // 8 warps, each 16 rows of a tile
constexpr int kMaxK = 1024;  // B's column tile, every chunk, fits in shared memory
constexpr int kEP = 40;      // epilogue pitch in words: int32 rows of 32 columns + 8
constexpr int kEPh = 20;     // the same for bf16 pairs: 16 words + 4
constexpr int kEWords = 16 * kEP;  // a warp's epilogue buffer

enum Mode { kRow16 = 0, kRow4 = 1, kTrans4 = 2, kGather = 3 };

struct Operand {
  const int8_t* p;
  long long rs, ks;  // element strides of a row (m of A, n of B) and of k
  int rows;          // M or N
  int mode;
};

// byte offset of byte lin of a K-contiguous tile: the 16-byte chunk index
// within each 128-byte line XOR the line's index (mod 8)
__device__ __forceinline__ int swz(int lin) { return lin ^ (((lin >> 7) & 7) << 4); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes));
}

// w[i] holds bytes (r, k+i) of rows r..r+3 (byte j = row r+j); after, w[j]
// holds bytes (r+j, k..k+3)
__device__ __forceinline__ void transpose4x4(uint32_t (&w)[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t c = __byte_perm(w[2], w[3], 0x5140), d = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(a, c, 0x5410);
  w[1] = __byte_perm(a, c, 0x7632);
  w[2] = __byte_perm(b, d, 0x5410);
  w[3] = __byte_perm(b, d, 0x7632);
}

__device__ __forceinline__ uint32_t byte_at(const Operand& o, int row, int k, int K) {
  return row < o.rows && k < K ? uint32_t(uint8_t(o.p[row * o.rs + k * o.ks])) : 0u;
}

// rows r0 .. r0+NR-1 of operand o, by cp.async of W bytes (W = 16 or 4):
// consecutive threads take consecutive pieces of a row
template <int KC, int NR, int W>
__device__ __forceinline__ void stage_rows(const Operand& o, int K, int r0, int k0, int8_t* s) {
  constexpr int kPer = KC / W;
  for (int u = threadIdx.x; u < NR * kPer; u += kThreads) {
    const int r = u / kPer, k = k0 + (u % kPer) * W, row = r0 + r;
    const int n = row < o.rows ? max(0, min(W, K - k)) : 0;
    const int8_t* src = n > 0 ? o.p + row * o.rs + k : o.p;
    if (W == 16)
      cp_async16(s + swz(r * KC + k - k0), src, n);
    else
      cp_async4(s + swz(r * KC + k - k0), src, n);
  }
}

// rows r0 .. r0+NR-1 of operand o, bytes k0 .. k0+KC-1, into the swizzled
// [NR][KC] tile s; zeros past K and past o.rows (NR a multiple of 4);
// kBatch: transposed units whose words are loaded together
template <int KC, int NR, int kBatch>
__device__ __forceinline__ void stage(const Operand& o, int K, int r0, int k0, int8_t* s) {
  if (o.mode == kRow16) {
    stage_rows<KC, NR, 16>(o, K, r0, k0, s);
  } else if (o.mode == kRow4) {
    stage_rows<KC, NR, 4>(o, K, r0, k0, s);
  } else if (o.mode == kTrans4) {
    // consecutive threads take consecutive quads of rows at one k: the
    // rows are contiguous, so a warp reads 128 contiguous bytes; the words
    // of kBatch units are loaded before any is transposed, so their
    // latencies overlap
    constexpr int kQuads = NR / 4, kAll = kQuads * (KC / 4);
#pragma unroll
    for (int u0 = threadIdx.x; u0 < kAll; u0 += kBatch * kThreads) {
      uint32_t w[kBatch][4];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kThreads;
        const int k = k0 + 4 * (u / kQuads), row = r0 + 4 * (u % kQuads);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (u >= kAll || k + i >= K || row >= o.rows) {
            w[j][i] = 0;
          } else if (row + 3 < o.rows) {
            w[j][i] = *reinterpret_cast<const uint32_t*>(o.p + row + (k + i) * o.ks);
          } else {
            w[j][i] = 0;
            for (int r = 0; r < 4; ++r) w[j][i] |= byte_at(o, row + r, k + i, K) << (8 * r);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int u = u0 + j * kThreads;
        if (u >= kAll) break;
        const int q = u % kQuads, k = 4 * (u / kQuads);
        transpose4x4(w[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<uint32_t*>(s + swz((4 * q + r) * KC + k)) = w[j][r];
      }
    }
  } else {
    for (int u = threadIdx.x; u < NR * (KC / 4); u += kThreads) {
      const int r = u % NR, k = k0 + 4 * (u / NR);
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) w |= byte_at(o, r0 + r, k + i, K) << (8 * i);
      *reinterpret_cast<uint32_t*>(s + swz(r * KC + k - k0)) = w;
    }
  }
}

// a warp's 16 rows × NT n-tiles of C fragments → out, 32 columns at a time
// through the warp's shared buffer e; scale: the warp's columns' (shared)
template <int NT, bool kBf16>
__device__ __forceinline__ void epilogue(const int (&acc)[NT][4], uint32_t* e, int m0, int n0,
                                         int M, int N, const float* scale,
                                         void* __restrict__ out, int vec_out) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < NT / 4; ++q) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * q + jj;
      if (!kBf16) {
        *reinterpret_cast<uint2*>(e + g * kEP + 8 * jj + 2 * t) =
            make_uint2(uint32_t(acc[j][0]), uint32_t(acc[j][1]));
        *reinterpret_cast<uint2*>(e + (g + 8) * kEP + 8 * jj + 2 * t) =
            make_uint2(uint32_t(acc[j][2]), uint32_t(acc[j][3]));
      } else {
        const float s0 = scale[8 * j + 2 * t], s1 = scale[8 * j + 2 * t + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat16 lo =
              __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[j][2 * h]), s0));
          const __nv_bfloat16 hi =
              __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc[j][2 * h + 1]), s1));
          e[(g + 8 * h) * kEPh + 4 * jj + t] = uint32_t(__bfloat16_as_ushort(lo)) |
                                               (uint32_t(__bfloat16_as_ushort(hi)) << 16);
        }
      }
    }
    __syncwarp();
    // 16 rows × 128 bytes (int32) or 64 (bf16): whole rows, 16 bytes a lane
    constexpr int kRowLanes = kBf16 ? 4 : 8, kPer = kBf16 ? 8 : 4, kPitch = kBf16 ? kEPh : kEP;
#pragma unroll
    for (int it = 0; it < 16 * kRowLanes / 32; ++it) {
      const int row = it * (32 / kRowLanes) + lane / kRowLanes, c = lane % kRowLanes;
      const int m = m0 + row, n = n0 + 32 * q + kPer * c;
      const uint4 v = *reinterpret_cast<const uint4*>(e + row * kPitch + 4 * c);
      if (m >= M || n >= N) continue;
      if (kBf16) {
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + (long long)m * N + n;
        if (vec_out && n + kPer <= N) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const uint16_t* h = reinterpret_cast<const uint16_t*>(&v);
          for (int i = 0; i < kPer && n + i < N; ++i) o[i] = __ushort_as_bfloat16(h[i]);
        }
      } else {
        int* o = static_cast<int*>(out) + (long long)m * N + n;
        if (vec_out && n + kPer <= N) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const int* w = reinterpret_cast<const int*>(&v);
          for (int i = 0; i < kPer && n + i < N; ++i) o[i] = w[i];
        }
      }
    }
    __syncwarp();
  }
}

// A block: 8 warps as WM = 8/WN row groups of 16 × WN column groups of NT
// n-tiles: a BM = 16·WM by BN = 8·NT·WN tile of out
template <int KS, int WN, int NT, bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
    int8_contract_kernel(Operand A, Operand B, int M, int N, int K,
                         const float* __restrict__ scale, void* __restrict__ out, int vec_out) {
  constexpr int KC = 32 * KS, BM = 16 * (8 / WN), BN = 8 * NT * WN;
  // A's transposed units loaded two at a time, one beside 16 n-tiles of
  // accumulators (two spilled there)
  constexpr int kBatchA = NT == 16 ? 1 : 2;
  extern __shared__ __align__(128) int8_t smem[];
  const int nchunks = (K + KC - 1) / KC;
  int8_t* sB = smem;                                              // [nchunks][BN][KC]
  int8_t* sA = sB + nchunks * BN * KC;                            // [2][BM][KC]
  uint32_t* sE = reinterpret_cast<uint32_t*>(sA + 2 * BM * KC);  // [8 warps][kEWords]
  float* sS = reinterpret_cast<float*>(sE + 8 * kEWords);        // [BN] scale
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.y * BN;
  const int tiles = (M + BM - 1) / BM;
  const int items = ((tiles - 1 - int(blockIdx.x)) / int(gridDim.x) + 1) * nchunks;
  auto issue = [&](int i) {
    const int tile = blockIdx.x + (i / nchunks) * gridDim.x;
    stage<KC, BM, kBatchA>(A, K, tile * BM, (i % nchunks) * KC, sA + (i & 1) * BM * KC);
    cp_async_commit();
  };
  // A's first (tile, chunk) in flight while B's column tile, every chunk,
  // is staged once; the first wait below covers both groups
  issue(0);
  for (int c = 0; c < nchunks; ++c) stage<KC, BN, 2>(B, K, n0, c * KC, sB + c * BN * KC);
  cp_async_commit();
  if (kBf16)
    for (int j = threadIdx.x; j < BN; j += kThreads) sS[j] = n0 + j < N ? scale[n0 + j] : 0.f;
  // ldmatrix rows: A (this warp's 16 rows), B (16 columns a pair of n-tiles)
  const int a_row = 16 * wm + (lane & 7) + ((lane >> 3) & 1) * 8, a_k = 16 * (lane >> 4);
  const int b_row = 8 * NT * wn + (lane & 7) + ((lane >> 4) & 1) * 8, b_k = 16 * ((lane >> 3) & 1);
  int acc[NT][4];
  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) {
      issue(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c = i % nchunks;
    if (c == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    }
    const int8_t* a_s = sA + (i & 1) * BM * KC;
    const int8_t* b_s = sB + c * BN * KC;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      uint32_t af[4];
      ldmatrix_x4(smem_u32(a_s + swz(a_row * KC + 32 * s + a_k)), af);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t bf[4];
        ldmatrix_x4(smem_u32(b_s + swz((16 * p + b_row) * KC + 32 * s + b_k)), bf);
        mma_s8(acc[2 * p], af, int(bf[0]), int(bf[1]));
        mma_s8(acc[2 * p + 1], af, int(bf[2]), int(bf[3]));
      }
    }
    if (c == nchunks - 1) {
      const int tile = blockIdx.x + (i / nchunks) * gridDim.x;
      epilogue<NT, kBf16>(acc, sE + warp * kEWords, tile * BM + 16 * wm, n0 + 8 * NT * wn, M,
                          N, sS + 8 * NT * wn, out, vec_out);
    }
    __syncthreads();  // the buffer issue(i + 2) overwrites is read
  }
}

__host__ __device__ constexpr int smem_bytes(int kc, int bm, int bn, int nchunks) {
  return nchunks * bn * kc + 2 * bm * kc + 8 * kEWords * 4 + bn * 4;
}

bool mode_fits(int mode, const void* p, long long rs, long long ks) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  switch (mode) {
    case kRow16: return ks == 1 && rs % 16 == 0 && a % 16 == 0;
    case kRow4: return ks == 1 && rs % 4 == 0 && a % 4 == 0;
    case kTrans4: return rs == 1 && ks % 4 == 0 && a % 4 == 0;
    case kGather: return true;
    default: return false;
  }
}

struct Call {
  Operand A, B;
  int M, N, K;
  const float* scale;
  void* out;
  int vec_out, n_sm;
  cudaStream_t st;
};

template <int KS, int WN, int NT, bool kBf16>
int launch(const Call& a) {
  constexpr int KC = 32 * KS, BM = 16 * (8 / WN), BN = 8 * NT * WN;
  const int nchunks = (a.K + KC - 1) / KC, smem = smem_bytes(KC, BM, BN, nchunks);
  auto kernel = int8_contract_kernel<KS, WN, NT, kBf16>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
  }
  // two blocks an SM (the launch bounds), fewer where shared memory says
  const int per_sm = std::max(1, std::min(2, 232448 / (smem + 1024)));
  const int tiles = (a.M + BM - 1) / BM, ny = (a.N + BN - 1) / BN;
  const int gx = std::max(1, std::min(tiles, per_sm * a.n_sm / ny));
  kernel<<<dim3(gx, ny), kThreads, smem, a.st>>>(a.A, a.B, a.M, a.N, a.K, a.scale, a.out,
                                                   a.vec_out);
  return int(cudaGetLastError());
}

// the tile: 128 columns where N > 64, else 64; the tallest of 128, 64 or 32
// rows that still gives every SM a block, else the shortest (small M: more
// blocks, each on the critical path of one staging and one epilogue)
template <int KS, bool kBf16>
int by_tile(const Call& a) {
  auto blocks = [&](int bm, int bn) {
    return (long long)((a.M + bm - 1) / bm) * ((a.N + bn - 1) / bn);
  };
  if (a.N > 64) {
    if (blocks(128, 128) >= a.n_sm) return launch<KS, 1, 16, kBf16>(a);
    if (blocks(64, 128) >= a.n_sm) return launch<KS, 2, 8, kBf16>(a);
    return launch<KS, 4, 4, kBf16>(a);
  }
  if (blocks(128, 64) >= a.n_sm) return launch<KS, 1, 8, kBf16>(a);
  return launch<KS, 2, 4, kBf16>(a);
}

template <bool kBf16>
int dispatch(const Call& a) {
  if (a.K <= 32) return by_tile<1, kBf16>(a);
  if (a.K <= 64) return by_tile<2, kBf16>(a);
  return by_tile<4, kBf16>(a);
}

}  // namespace ic
}  // namespace mdcv

// a, b int8 (strided views, element strides); mode_a, mode_b how each is
// staged (0 rows by 16 bytes, 1 rows by 4 bytes, 2 transposed 4-byte
// words, 3 bytes; refused where the strides or the base do not allow it);
// scale (N,) f32 or null; out row-major (M, N) int32 (out_dtype 3) or, with
// scale, bf16 (out_dtype 1). 1 ≤ K ≤ 1024.
extern "C" int mdcv_int8_contract(const void* a, const void* b, const void* scale, void* out,
                                  int M, int N, int K, long long sam, long long sak,
                                  long long sbk, long long sbn, int mode_a, int mode_b,
                                  int out_dtype, void* stream) {
  using namespace mdcv::ic;
  const bool bf16 = out_dtype == 1;
  if (M < 0 || N < 0 || K <= 0 || K > kMaxK || (bf16 != (scale != nullptr)) ||
      (out_dtype != 1 && out_dtype != 3) || !mode_fits(mode_a, a, sam, sak) ||
      !mode_fits(mode_b, b, sbn, sbk))
    return int(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
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
  const Operand A{static_cast<const int8_t*>(a), sam, sak, M, mode_a};
  const Operand B{static_cast<const int8_t*>(b), sbn, sbk, N, mode_b};
  const size_t esize = bf16 ? 2 : 4;
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && (size_t(N) * esize) % 16 == 0;
  const Call call{A, B, M, N, K, static_cast<const float*>(scale), out, vec_out, n_sm,
                  static_cast<cudaStream_t>(stream)};
  return bf16 ? dispatch<true>(call) : dispatch<false>(call);
}
