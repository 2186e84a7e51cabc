// strided_map — one strided gather with an elementwise op or a per-program
// sum. The output index (i0, i1, i2, i3) (rank ≤ 4, dim 0 the "program")
// reads the input at
//
//   base(i0) + i0·s0 + i1·s1 + i2·s2 + i3·s3,
//   base(i0) = idx0[i0]·t0 + idx1[i0]·t1 + idx2[i0]·t2   (each idx optional)
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
// computation, so one kernel takes them all: slices, transposes, permutes
// and reshapes are strides; the DMA windows are the per-program base.
//
// An offset outside the input's storage (a per-program base past its end)
// traps: the launch fails and the error surfaces at the next
// synchronisation, where the plain version raises IndexError; nothing is
// read out of bounds.
//
// Maps: a grid-stride loop, one element per thread per step, 32-bit index
// arithmetic where the output has < 2³¹ elements. Reduce: a (chunks,
// programs) grid, each block summing 65536 elements of one program into a
// partial (16-byte loads where the block is dense and aligned), then one
// block per program adds its partials in a fixed order — deterministic, and
// within the f32 tolerance of ops/strided_map.py. Bound: bytes.
#include "common.cuh"

namespace mdcv {
namespace sm {

enum Op { kCopy = 0, kScale = 1, kQuantize = 2, kCompare = 3, kSum = 4 };
constexpr int kChunk = 65536;  // elements per reduce block (ops/strided_map.py)
constexpr int kThreads = 256;

struct Params {
  long long d[4], s[4], o[4], t[3];
  long long chunks, dense;
  long long lo, hi;  // the storage, as element offsets from src: [lo, hi)
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

__device__ __forceinline__ void store_f32(char* p, long long i, int code, float v) {
  switch (code) {
    case 0: reinterpret_cast<float*>(p)[i] = v; break;
    case 1: reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v); break;
    case 2: reinterpret_cast<int8_t*>(p)[i] = int8_t(int(v)); break;
    default: reinterpret_cast<int*>(p)[i] = int(v); break;
  }
}

__device__ __forceinline__ long long base_of(long long i0, const int* idx0, const int* idx1,
                                             const int* idx2, const Params& p) {
  long long b = i0 * p.s[0];
  if (idx0) b += (long long)idx0[i0] * p.t[0];
  if (idx1) b += (long long)idx1[i0] * p.t[1];
  if (idx2) b += (long long)idx2[i0] * p.t[2];
  return b;
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    map_kernel(const char* __restrict__ src, char* __restrict__ out, const int* idx0,
               const int* idx1, const int* idx2, Params p, int in_code, int out_code, int op,
               float c, Idx total) {
  const Idx d1 = Idx(p.d[1]), d2 = Idx(p.d[2]), d3 = Idx(p.d[3]);
  for (Idx e = Idx(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += Idx(gridDim.x) * kThreads) {
    Idx t = e;
    const Idx i3 = t % d3;
    t /= d3;
    const Idx i2 = t % d2;
    t /= d2;
    const Idx i1 = t % d1;
    const Idx i0 = t / d1;
    const long long in = base_of(i0, idx0, idx1, idx2, p) + i1 * p.s[1] + i2 * p.s[2] +
                         i3 * p.s[3];
    if (in < p.lo || in >= p.hi) __trap();
    const long long o = i0 * p.o[0] + i1 * p.o[1] + i2 * p.o[2] + i3 * p.o[3];
    if (op == kCopy) {
      switch (elsize(in_code)) {
        case 1: reinterpret_cast<int8_t*>(out)[o] = reinterpret_cast<const int8_t*>(src)[in]; break;
        case 2: reinterpret_cast<int16_t*>(out)[o] = reinterpret_cast<const int16_t*>(src)[in]; break;
        default: reinterpret_cast<int*>(out)[o] = reinterpret_cast<const int*>(src)[in]; break;
      }
      continue;
    }
    const float x = load_f32(src, in, in_code);
    float v;
    if (op == kScale) {
      v = __fmul_rn(x, c);
    } else if (op == kQuantize) {
      const float r = rintf(__fmul_rn(x, c));
      v = r != r ? 0.f : fminf(fmaxf(r, -127.f), 127.f);
    } else {
      v = x > 0.f ? 1.f : 0.f;
    }
    store_f32(out, o, out_code, v);
  }
}

// partial[i0 · chunks + chunk] = Σ f32(x) over elements [chunk·kChunk, +kChunk)
// of program i0's block (d1·d2·d3 elements)
__global__ void __launch_bounds__(kThreads)
    sum_partial_kernel(const char* __restrict__ src, float* __restrict__ partial,
                       const int* idx0, const int* idx1, const int* idx2, Params p,
                       int in_code) {
  __shared__ float scratch[kThreads / kWarp];
  const long long i0 = blockIdx.y, chunk = blockIdx.x;
  const long long n = p.d[1] * p.d[2] * p.d[3];
  const long long j0 = chunk * kChunk, j1 = j0 + kChunk < n ? j0 + kChunk : n;
  const long long base = base_of(i0, idx0, idx1, idx2, p);
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

}  // namespace sm
}  // namespace mdcv

// params: int64[19] = d0..d3 (output dims, d0 the programs), s0..s3 (input
// strides, ≥ 0), o0..o3 (output strides), t0..t2 (strides of idx0..idx2),
// chunks (reduce: partials per program), dense (reduce: each block
// contiguous), lo, hi (the input's storage as element offsets from src).
// src points at the view's first element; idx* are int32 (P,) or null.
// partial: float (P·chunks,) in reduce mode (op 4), else unused.
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
  const char* s = static_cast<const char*>(src);
  const int *i0 = static_cast<const int*>(idx0), *i1 = static_cast<const int*>(idx1),
            *i2 = static_cast<const int*>(idx2);
  if (op == kSum) {
    const long long n = p.d[1] * p.d[2] * p.d[3];
    if (out_code != 0 || partial == nullptr || p.chunks != (n + kChunk - 1) / kChunk ||
        p.chunks > 0x7fffffffLL || p.d[0] > 65535)
      return int(cudaErrorInvalidValue);
    float* part = static_cast<float*>(partial);
    sum_partial_kernel<<<dim3(unsigned(p.chunks), unsigned(p.d[0])), kThreads, 0, st>>>(
        s, part, i0, i1, i2, p, in_code);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    sum_final_kernel<<<unsigned(p.d[0]), kThreads, 0, st>>>(part, static_cast<float*>(out),
                                                            p.chunks);
    return int(cudaGetLastError());
  }
  const long long total = p.d[0] * p.d[1] * p.d[2] * p.d[3];
  const long long want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = unsigned(want < 1048576 ? want : 1048576);
  char* o = static_cast<char*>(out);
  if (total < (1LL << 31))  // the grid-stride step cannot wrap 32 bits
    map_kernel<unsigned><<<blocks, kThreads, 0, st>>>(s, o, i0, i1, i2, p, in_code, out_code,
                                                       op, c, unsigned(total));
  else
    map_kernel<unsigned long long><<<blocks, kThreads, 0, st>>>(
        s, o, i0, i1, i2, p, in_code, out_code, op, c, (unsigned long long)total);
  return int(cudaGetLastError());
}
