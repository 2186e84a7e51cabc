// strided_map — one strided gather with an elementwise op or a per-program
// sum. The output index (i0, i1, i2, i3) (rank ≤ 4, dim 0 the "program")
// reads the input at
//
//   base(i0) + i1·s1 + i2·s2 + i3·s3,
//   base(i0) = i0·s0 + idx0[i0]·t0 + idx1[i0]·t1 + idx2[i0]·t2   (each idx optional)
//
// (element strides, any of them 0) and writes out[i0·o0 + … + i3·o3] =
//   copy     the element itself (any element size; the bytes are moved),
//   scale    dtype(f32(x) · c),
//   quantize int8(clip(rint(f32(x) · c), −127, 127)), NaN → 0,
//   compare  x > 0 ? 1 : 0 in the output dtype,
// or, in reduce mode, out[i0] = Σ f32(x) over the program's block.
//
// Replaces the TPU probes whose kernels move, map or sum bytes:
// tools/probe_mosaic.py:61, :72, :83, :103, :129 (P2a, P2b, P3, P4, P6),
// probe_mosaic2.py:64, :76, :89, :185 (T1a, T1b, T1c, Q5),
// probe_mosaic3.py:68, :98, :109, :172 (P12, T14, T15, Q8),
// probe_mosaic5.py:70 (Q8), probe_mosaic6.py:96, :126, :142 (P15, Q16,
// Q17), probe_mosaic7.py:123 (Q18), probe_crop_kernel.py:77 (P20),
// probe_crop_dma.py:50 (D1–D4), tools/reprobe.py:89 (its copies,
// dynamic_ds, bf16_compare) and :201 (its three DMA probes). On the TPU
// these were questions of what Mosaic could lower (strided sublane slices,
// lane merges, dynamic DMA windows); on Hopper each is an address
// computation: slices, transposes, permutes and reshapes are strides; the
// DMA windows are the per-program base.
//
// Bound: bytes. A map is one of three kernels, which the wrapper picks once
// per call from the view's strides (ops/strided_map.py:pick_path, after
// dropping size-1 dims and merging dims contiguous in both input and
// output), with the op and both dtypes as template parameters:
//
// - rows: the inner dim is contiguous in input and output (Q8, the slices,
//   the windows, the DMA bases). A 2-D grid over (row, 16-byte slot of the
//   row): a thread loads 16 bytes of input (8 bf16 → 8 int8 for Q8's
//   quantize) and stores them whole where the output is aligned; the
//   slots follow the input's 16-byte grid, so a row's unaligned head and
//   tail are partial slots done element by element. A row's base is
//   computed once (its index split by multiply-high, FastDiv), not per
//   element; a whole contiguous map (one row on the 16-byte grid) skips
//   even that (a 32 KB scale: 0.00152 ms on the device with the row
//   split, 0.00123 without, in two calls; a bare 16-byte copy kernel
//   0.00115; PERF.md §6).
// - transpose: the input's unit-stride dim is not the output's (T1c, T14,
//   T15; from 2¹⁶ elements, below which T1a, T1b and transpose_2d go
//   generic): 32 × 32 element tiles (64 × 64 for int8) through padded
//   shared memory, read along the input's unit dim and written along the
//   output's, both coalesced.
// - generic: the rest (a broadcast or a strided inner dim, a transpose
//   under 2¹⁶ elements): one element a thread, its index split by
//   multiply-high.
//
// A base outside the input's storage traps: the rows and generic kernels
// check each row's (program's) span [base, base + Σ (d_k − 1)·s_k] once,
// which holds exactly the elements it reads (strides ≥ 0), so they trap on
// the inputs where the plain version raises IndexError; nothing is read out
// of bounds. A view without index arrays lies in its storage (torch
// checks it) and takes any of the three.
//
// Quantize without conversion instructions: NaN → 0, clamp to ±127, then
// + 1.5·2²³ rounds half to even and leaves the int8 in the low byte
// (int8_mma.cuh:q8_bits, with NaN taken to 0 first rather than to −127).
//
// Sums (1.91–2.15 TB/s, 8× torch.sum, PERF.md §6): a (chunks,
// programs) grid, each block summing 65536 elements of one program into a
// partial (16-byte loads where the block is dense and aligned), then one
// block per program adds its partials in a fixed order — deterministic, and
// within the f32 tolerance of ops/strided_map.py. Two launches a call.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace mdcv {
namespace sm {

enum Op { kCopy = 0, kScale = 1, kQuantize = 2, kCompare = 3, kSum = 4 };
enum Path { kRows = 0, kTranspose = 1, kGeneric = 2 };
constexpr int kChunk = 65536;  // elements per reduce block (ops/strided_map.py)
constexpr int kThreads = 256;

struct Params {
  long long d[4], s[4], o[4], t[3];
  long long chunks, dense;
  long long lo, hi;  // the storage, as element offsets from src: [lo, hi)
  long long path;
};

// n / d and n % d for n < 2³¹ by a multiply-high, an add and a shift
// (d ≥ 1): the rows, transpose and generic kernels split their flat
// indices with it, where a division would cost ~20 dependent instructions
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(long long dd) : d(uint32_t(dd)), s(0) {
    while (s < 32 && (1ull << s) < d) ++s;
    m = uint32_t(((1ull << 32) * ((1ull << s) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (__umulhi(n, m) + n) >> s; }
  __device__ __forceinline__ uint32_t mod(uint32_t n) const { return n - div(n) * d; }
};

struct Index {
  const int *i0, *i1, *i2;
  __host__ __device__ __forceinline__ bool any() const { return i0 || i1 || i2; }
};

__host__ __device__ __forceinline__ int elsize(int code) {
  return code == 1 ? 2 : (code == 2 ? 1 : 4);  // f32 0, bf16 1, int8 2, int32 3
}

__device__ __forceinline__ float load_f32(const char* p, long long i, int code) {
  switch (code) {
    case 0: return reinterpret_cast<const float*>(p)[i];
    case 1: return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
    case 2: return float(reinterpret_cast<const int8_t*>(p)[i]);
    default: return __int2float_rn(reinterpret_cast<const int*>(p)[i]);
  }
}

__device__ __forceinline__ long long base_of(long long i0, const Index& ix, const Params& p) {
  long long b = i0 * p.s[0];
  if (ix.i0) b += (long long)ix.i0[i0] * p.t[0];
  if (ix.i1) b += (long long)ix.i1[i0] * p.t[1];
  if (ix.i2) b += (long long)ix.i2[i0] * p.t[2];
  return b;
}

// ---------------------------------------------------------------------------
// the element ops
// ---------------------------------------------------------------------------

__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bool positive(float x) { return x > 0.f; }
__device__ __forceinline__ bool positive(__nv_bfloat16 x) { return __bfloat162float(x) > 0.f; }
__device__ __forceinline__ bool positive(int8_t x) { return x > 0; }
__device__ __forceinline__ bool positive(int x) { return x > 0; }

template <typename T> __device__ __forceinline__ T one();
template <> __device__ __forceinline__ float one<float>() { return 1.f; }
template <> __device__ __forceinline__ __nv_bfloat16 one<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0x3f80);
}
template <> __device__ __forceinline__ int8_t one<int8_t>() { return 1; }
template <> __device__ __forceinline__ int one<int>() { return 1; }
template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

template <int Op, typename In, typename Out>
__device__ __forceinline__ Out apply(In x, float c) {
  if constexpr (Op == kCopy) {
    return x;
  } else if constexpr (Op == kScale) {
    return from_f32<Out>(__fmul_rn(as_f32(x), c));
  } else if constexpr (Op == kQuantize) {
    float v = __fmul_rn(as_f32(x), c);
    v = v != v ? 0.f : fminf(fmaxf(v, -127.f), 127.f);
    return static_cast<int8_t>(__float_as_uint(__fadd_rn(v, 12582912.f)) & 0xff);
  } else {
    return positive(x) ? one<Out>() : zero<Out>();
  }
}

// V outputs to p: whole stores of min(16, bytes) where p is that aligned
template <typename Out, int V>
__device__ __forceinline__ void store_vec(Out* p, const Out (&y)[V]) {
  constexpr int kBytes = V * int(sizeof(Out));
  constexpr int kPiece = kBytes < 16 ? kBytes : 16;
  if (reinterpret_cast<uintptr_t>(p) % kPiece == 0) {
#pragma unroll
    for (int i = 0; i < kBytes / kPiece; ++i) {
      const char* src = reinterpret_cast<const char*>(y) + i * kPiece;
      char* dst = reinterpret_cast<char*>(p) + i * kPiece;
      if constexpr (kPiece == 16)
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      else if constexpr (kPiece == 8)
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      else
        *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
    }
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) p[u] = y[u];
  }
}

// ---------------------------------------------------------------------------
// the three map kernels
// ---------------------------------------------------------------------------

// rows (i0, i1, i2) on y, 16-byte slots of the row on x; flat: one row
// starting on the 16-byte grid (a whole contiguous map: Q8), whose slot v
// is elements [v·V, (v + 1)·V), with no row split, base or grid offset
template <int Op, typename In, typename Out, typename Idx>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const In* __restrict__ src, Out* __restrict__ out, Index ix, Params p, float c,
                Idx rows, Idx slots, FastDiv f1, FastDiv f2, int flat) {
  constexpr int V = 16 / int(sizeof(In));
  const long long d3 = p.d[3];
  if (flat) {
    for (Idx v = Idx(blockIdx.x) * blockDim.x + threadIdx.x; v < slots;
         v += Idx(gridDim.x) * blockDim.x) {
      const long long e0 = (long long)v * V;
      if (e0 + V <= d3) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + e0);
        const In* x = reinterpret_cast<const In*>(&raw);
        alignas(16) Out y[V];
#pragma unroll
        for (int u = 0; u < V; ++u) y[u] = apply<Op, In, Out>(x[u], c);
        store_vec<Out, V>(out + e0, y);
      } else {
        for (long long e = e0; e < d3; ++e) out[e] = apply<Op, In, Out>(src[e], c);
      }
    }
    return;
  }
  const Idx d1 = Idx(p.d[1]), d2 = Idx(p.d[2]);
  const bool checked = ix.any();
  for (Idx r = Idx(blockIdx.y) * blockDim.y + threadIdx.y; r < rows;
       r += Idx(gridDim.y) * blockDim.y) {
    Idx i2, i1, i0;
    if constexpr (sizeof(Idx) == 4) {
      const Idx t = f2.div(r);
      i2 = r - t * d2, i0 = f1.div(t), i1 = t - i0 * d1;
    } else {
      const Idx t = r / d2;
      i2 = r % d2, i1 = t % d1, i0 = t / d1;
    }
    const long long ib = base_of(i0, ix, p) + i1 * p.s[1] + i2 * p.s[2];
    if (checked && (ib < p.lo || ib + d3 - 1 >= p.hi)) __trap();
    const In* ip = src + ib;
    Out* op = out + (i0 * p.o[0] + i1 * p.o[1] + i2 * p.o[2]);
    // elements of the row before the input's 16-byte grid: slot v holds
    // elements [v·V − a, (v + 1)·V − a)
    const int a = int(reinterpret_cast<uintptr_t>(ip) % 16) / int(sizeof(In));
    const Idx n_slots = Idx((a + d3 + V - 1) / V);
    for (Idx v = Idx(blockIdx.x) * blockDim.x + threadIdx.x; v < n_slots && v < slots;
         v += Idx(gridDim.x) * blockDim.x) {
      const long long e0 = (long long)v * V - a;
      if (e0 >= 0 && e0 + V <= d3) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ip + e0);
        const In* x = reinterpret_cast<const In*>(&raw);
        alignas(16) Out y[V];
#pragma unroll
        for (int u = 0; u < V; ++u) y[u] = apply<Op, In, Out>(x[u], c);
        store_vec<Out, V>(op + e0, y);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const long long e = e0 + u;
          if (e >= 0 && e < d3) op[e] = apply<Op, In, Out>(ip[e], c);
        }
      }
    }
  }
}

// s2 == 1 (the input's unit dim), o3 == 1 (the output's): T × T tiles of
// (dim 2, dim 3), read along dim 2 and written along dim 3; (i0, i1) on z
template <int Op, typename In, typename Out, int T>
__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const In* __restrict__ src, Out* __restrict__ out, Params p, float c,
                     FastDiv f1) {
  constexpr int kPad = sizeof(In) == 1 ? 4 : 1;  // conflict-free column reads
  using Word = std::conditional_t<sizeof(In) == 1, uint8_t,
                                  std::conditional_t<sizeof(In) == 2, uint16_t, uint32_t>>;
  __shared__ Word tile[T][T + kPad];  // the elements' bits
  const Word* iw = reinterpret_cast<const Word*>(src);
  const long long d1 = p.d[1], d2 = p.d[2], d3 = p.d[3], outer = p.d[0] * d1;
  const long long c0 = (long long)blockIdx.x * T, k_tiles = (d2 + T - 1) / T;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (long long z = blockIdx.z; z < outer; z += gridDim.z) {  // outer < 2³¹
    const long long i0 = f1.div(uint32_t(z)), i1 = z - i0 * d1;
    const Word* ip = iw + i0 * p.s[0] + i1 * p.s[1];
    Out* op = out + i0 * p.o[0] + i1 * p.o[1];
    for (long long kt = blockIdx.y; kt < k_tiles; kt += gridDim.y) {
      const long long k0 = kt * T;
#pragma unroll
      for (int cc = ty; cc < T; cc += kThreads / 32)
#pragma unroll
        for (int kk = tx; kk < T; kk += 32)
          if (k0 + kk < d2 && c0 + cc < d3) tile[cc][kk] = ip[k0 + kk + (c0 + cc) * p.s[3]];
      __syncthreads();
#pragma unroll
      for (int kk = ty; kk < T; kk += kThreads / 32)
#pragma unroll
        for (int cc = tx; cc < T; cc += 32)
          if (k0 + kk < d2 && c0 + cc < d3)
            op[(k0 + kk) * p.o[2] + c0 + cc] =
                apply<Op, In, Out>(*reinterpret_cast<const In*>(&tile[cc][kk]), c);
      __syncthreads();
    }
  }
}

// programs on y, their elements on x (one a thread, by division)
template <int Op, typename In, typename Out, typename Idx>
__global__ void __launch_bounds__(kThreads)
    generic_kernel(const In* __restrict__ src, Out* __restrict__ out, Index ix, Params p,
                   float c, Idx n_block, FastDiv f2, FastDiv f3) {
  const Idx d2 = Idx(p.d[2]), d3 = Idx(p.d[3]);
  const bool checked = ix.any();
  for (long long i0 = blockIdx.y; i0 < p.d[0]; i0 += gridDim.y) {
    const long long base = base_of(i0, ix, p);
    if (checked && (base < p.lo || base + (p.d[1] - 1) * p.s[1] + (p.d[2] - 1) * p.s[2] +
                                           (p.d[3] - 1) * p.s[3] >= p.hi))
      __trap();
    for (Idx e = Idx(blockIdx.x) * kThreads + threadIdx.x; e < n_block;
         e += Idx(gridDim.x) * kThreads) {
      Idx i3, i2, i1;
      if constexpr (sizeof(Idx) == 4) {
        const Idx t = f3.div(e);
        i3 = e - t * d3, i1 = f2.div(t), i2 = t - i1 * d2;
      } else {
        const Idx t = e / d3;
        i3 = e % d3, i2 = t % d2, i1 = t / d2;
      }
      const long long o = i0 * p.o[0] + i1 * p.o[1] + i2 * p.o[2] + i3 * p.o[3];
      out[o] = apply<Op, In, Out>(src[base + i1 * p.s[1] + i2 * p.s[2] + i3 * p.s[3]], c);
    }
  }
}

// ---------------------------------------------------------------------------
// block sums
// ---------------------------------------------------------------------------

// partial[i0 · chunks + chunk] = Σ f32(x) over elements [chunk·kChunk, +kChunk)
// of program i0's block (d1·d2·d3 elements)
__global__ void __launch_bounds__(kThreads)
    sum_partial_kernel(const char* __restrict__ src, float* __restrict__ partial, Index ix,
                       Params p, int in_code) {
  __shared__ float scratch[kThreads / kWarp];
  const long long i0 = blockIdx.y, chunk = blockIdx.x;
  const long long n = p.d[1] * p.d[2] * p.d[3];
  const long long j0 = chunk * kChunk, j1 = j0 + kChunk < n ? j0 + kChunk : n;
  const long long base = base_of(i0, ix, p);
  // strides are ≥ 0: the block spans [base, base + Σ (d_k − 1)·s_k]
  const long long last =
      base + (p.d[1] - 1) * p.s[1] + (p.d[2] - 1) * p.s[2] + (p.d[3] - 1) * p.s[3];
  if (base < p.lo || last >= p.hi) __trap();
  const int es = elsize(in_code);
  float acc = 0.f;
  const char* start = src + (base + j0) * es;
  if (p.dense && (reinterpret_cast<uintptr_t>(start) % 16) == 0) {
    // the block is one contiguous run: 16-byte loads, then the tail
    const int per = 16 / es;
    const long long nvec = (j1 - j0) / per;
    const int4* v = reinterpret_cast<const int4*>(start);
#pragma unroll 4
    for (long long q = threadIdx.x; q < nvec; q += kThreads) {
      const int4 w = v[q];
      const char* b = reinterpret_cast<const char*>(&w);
      for (int u = 0; u < per; ++u) acc += load_f32(b, u, in_code);
    }
    for (long long j = j0 + nvec * per + threadIdx.x; j < j1; j += kThreads)
      acc += load_f32(src, base + j, in_code);
  } else {
    const long long d2 = p.d[2], d3 = p.d[3];
    for (long long j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const long long i3 = j % d3, i2 = (j / d3) % d2, i1 = j / (d2 * d3);
      acc += load_f32(src, base + i1 * p.s[1] + i2 * p.s[2] + i3 * p.s[3], in_code);
    }
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) partial[i0 * p.chunks + chunk] = total;
}

__global__ void __launch_bounds__(kThreads)
    sum_final_kernel(const float* __restrict__ partial, float* __restrict__ out,
                     long long chunks) {
  __shared__ float scratch[kThreads / kWarp];
  float acc = 0.f;
  for (long long q = threadIdx.x; q < chunks; q += kThreads)
    acc += partial[blockIdx.x * chunks + q];
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int Op, typename In, typename Out>
int launch_map(const void* src, void* out, const Index& ix, const Params& p, float c,
               cudaStream_t st) {
  const In* s = static_cast<const In*>(src);
  Out* o = static_cast<Out*>(out);
  constexpr long long k32 = 1LL << 31;
  if (p.path == kRows) {
    constexpr long long V = 16 / sizeof(In);
    const long long rows = p.d[0] * p.d[1] * p.d[2], slots = (V - 1 + p.d[3] + V - 1) / V;
    int bx = 1;
    while (bx < slots && bx < kThreads) bx *= 2;
    const int by = kThreads / bx;
    const dim3 grid(unsigned(std::min((slots + bx - 1) / bx, k32 - 1)),
                    unsigned(std::min((rows + by - 1) / by, 65535LL)));
    const FastDiv f1(p.d[1]), f2(p.d[2]);
    const int flat = rows == 1 && !ix.any() && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    if (rows < k32 / 2 && slots < k32 / 2)
      rows_kernel<Op, In, Out, unsigned><<<grid, dim3(bx, by), 0, st>>>(
          s, o, ix, p, c, unsigned(rows), unsigned(slots), f1, f2, flat);
    else
      rows_kernel<Op, In, Out, unsigned long long><<<grid, dim3(bx, by), 0, st>>>(
          s, o, ix, p, c, (unsigned long long)rows, (unsigned long long)slots, f1, f2, flat);
  } else if (p.path == kTranspose) {
    constexpr int T = sizeof(In) == 1 ? 64 : 32;
    const dim3 grid(unsigned(std::min((p.d[3] + T - 1) / T, k32 - 1)),
                    unsigned(std::min((p.d[2] + T - 1) / T, 65535LL)),
                    unsigned(std::min(p.d[0] * p.d[1], 65535LL)));
    transpose_kernel<Op, In, Out, T><<<grid, kThreads, 0, st>>>(s, o, p, c, FastDiv(p.d[1]));
  } else {
    const long long n = p.d[1] * p.d[2] * p.d[3];
    const long long gy = std::min(p.d[0], 65535LL);
    const long long gx = std::min((n + kThreads - 1) / kThreads, std::max(1LL, (1LL << 20) / gy));
    const FastDiv f2(p.d[2]), f3(p.d[3]);
    if (n < k32 / 2)
      generic_kernel<Op, In, Out, unsigned><<<dim3(unsigned(gx), unsigned(gy)), kThreads, 0, st>>>(
          s, o, ix, p, c, unsigned(n), f2, f3);
    else
      generic_kernel<Op, In, Out, unsigned long long>
          <<<dim3(unsigned(gx), unsigned(gy)), kThreads, 0, st>>>(
              s, o, ix, p, c, (unsigned long long)n, f2, f3);
  }
  return int(cudaGetLastError());
}

template <typename In>
int launch_compare(int out_code, const void* src, void* out, const Index& ix, const Params& p,
                   cudaStream_t st) {
  switch (out_code) {
    case 0: return launch_map<kCompare, In, float>(src, out, ix, p, 0.f, st);
    case 1: return launch_map<kCompare, In, __nv_bfloat16>(src, out, ix, p, 0.f, st);
    case 2: return launch_map<kCompare, In, int8_t>(src, out, ix, p, 0.f, st);
    default: return launch_map<kCompare, In, int>(src, out, ix, p, 0.f, st);
  }
}

int dispatch_map(int op, int in_code, int out_code, const void* src, void* out, const Index& ix,
                 const Params& p, float c, cudaStream_t st) {
  if (op == kCopy) {
    switch (elsize(in_code)) {
      case 1: return launch_map<kCopy, uint8_t, uint8_t>(src, out, ix, p, c, st);
      case 2: return launch_map<kCopy, uint16_t, uint16_t>(src, out, ix, p, c, st);
      default: return launch_map<kCopy, uint32_t, uint32_t>(src, out, ix, p, c, st);
    }
  }
  if (op == kScale)
    return in_code == 0 ? launch_map<kScale, float, float>(src, out, ix, p, c, st)
                        : launch_map<kScale, __nv_bfloat16, __nv_bfloat16>(src, out, ix, p, c, st);
  if (op == kQuantize)
    return in_code == 0 ? launch_map<kQuantize, float, int8_t>(src, out, ix, p, c, st)
                        : launch_map<kQuantize, __nv_bfloat16, int8_t>(src, out, ix, p, c, st);
  switch (in_code) {
    case 0: return launch_compare<float>(out_code, src, out, ix, p, st);
    case 1: return launch_compare<__nv_bfloat16>(out_code, src, out, ix, p, st);
    case 2: return launch_compare<int8_t>(out_code, src, out, ix, p, st);
    default: return launch_compare<int>(out_code, src, out, ix, p, st);
  }
}

}  // namespace sm
}  // namespace mdcv

// params: int64[20] = d0..d3 (output dims, d0 the programs), s0..s3 (input
// strides, ≥ 0), o0..o3 (output strides), t0..t2 (strides of idx0..idx2),
// chunks (reduce: partials per program), dense (reduce: each block
// contiguous), lo, hi (the input's storage as element offsets from src),
// path (maps: 0 rows, needing s3 = o3 = 1; 1 transpose, needing s2 = o3 = 1,
// no index and d0·d1 < 2³¹; 2 generic). src points at the view's first element; idx*
// are int32 (P,) or null. partial: float (P·chunks,) in reduce mode (op
// 4), else unused.
extern "C" int mdcv_strided_map(const void* src, void* out, const void* idx0, const void* idx1,
                                const void* idx2, const void* params, int in_code,
                                int out_code, int op, float c, void* partial, void* stream) {
  using namespace mdcv::sm;
  Params p;
  const long long* q = static_cast<const long long*>(params);
  for (int i = 0; i < 4; ++i) {
    p.d[i] = q[i];
    p.s[i] = q[4 + i];
    p.o[i] = q[8 + i];
  }
  for (int i = 0; i < 3; ++i) p.t[i] = q[12 + i];
  p.chunks = q[15];
  p.dense = q[16];
  p.lo = q[17];
  p.hi = q[18];
  p.path = q[19];
  for (int i = 0; i < 4; ++i) {
    if (p.d[i] <= 0) return p.d[i] == 0 ? 0 : int(cudaErrorInvalidValue);
    if (p.s[i] < 0) return int(cudaErrorInvalidValue);
  }
  if (in_code < 0 || in_code > 3 || out_code < 0 || out_code > 3 || op < 0 || op > 4)
    return int(cudaErrorInvalidValue);
  if (op == kCopy && elsize(in_code) != elsize(out_code)) return int(cudaErrorInvalidValue);
  if ((op == kScale || op == kQuantize) && (in_code > 1 || (op == kScale && out_code != in_code) ||
                                           (op == kQuantize && out_code != 2)))
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const Index ix{static_cast<const int*>(idx0), static_cast<const int*>(idx1),
                 static_cast<const int*>(idx2)};
  if (op == kSum) {
    const long long n = p.d[1] * p.d[2] * p.d[3];
    if (out_code != 0 || partial == nullptr || p.chunks != (n + kChunk - 1) / kChunk ||
        p.chunks > 0x7fffffffLL || p.d[0] > 65535)
      return int(cudaErrorInvalidValue);
    float* part = static_cast<float*>(partial);
    sum_partial_kernel<<<dim3(unsigned(p.chunks), unsigned(p.d[0])), kThreads, 0, st>>>(
        static_cast<const char*>(src), part, ix, p, in_code);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    sum_final_kernel<<<unsigned(p.d[0]), kThreads, 0, st>>>(part, static_cast<float*>(out),
                                                            p.chunks);
    return int(cudaGetLastError());
  }
  const bool indexed = idx0 || idx1 || idx2;
  const bool unit3 = p.d[3] == 1 || (p.s[3] == 1 && p.o[3] == 1);
  const bool ok = p.path == kGeneric || (p.path == kRows && unit3) ||
                  (p.path == kTranspose && !indexed && p.s[2] == 1 && p.o[3] == 1 &&
                   p.d[0] * p.d[1] < (1LL << 31));
  if (!ok) return int(cudaErrorInvalidValue);
  return dispatch_map(op, in_code, out_code, src, out, ix, p, c, st);
}
