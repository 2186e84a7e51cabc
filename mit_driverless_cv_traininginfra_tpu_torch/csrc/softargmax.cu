// K2 — fused flat softmax + soft-argmax, forward and backward.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_kernels.py:_pallas_softargmax (body _softargmax_kernel), which
// runs max → exp → sum → normalise → two weighted sums on 64-row VMEM
// tiles of the (M, H·W) logits.
//
// Forward, on the card: one block per row of H·W (6400 at 80×80), whose
// threads hold the whole row in registers — kPerThread (40) values each,
// 160 threads at 6400 — read once as 16-byte vectors (8 bf16 or 4
// f32), so the row is read from device memory once and the probabilities
// written once, also as 16-byte vectors. A row whose length is not a
// multiple of the vector (13×17, 1×7) is read and written element by
// element with a masked tail; a row longer than the block's registers
// takes the rest from memory again in each sweep. The coordinates are the
// w-entry xs and h-entry ys tables in shared memory (xv[i] = xs[i % w],
// yv[i] = ys[i / w] by construction, both bit-equal to the JAX package's
// linspace grids), not two H·W rows; where w is a multiple of the vector,
// a vector lies in one map row and reads its xs as 16 bytes and one ys.
// Three block reductions — max, sum, then E[x] and E[y] together — each
// through warp shuffles and one shared-memory step; the per-thread sums
// are taken per vector first, so no chain is longer than a vector. All in
// f32 whatever the logits' dtype: exp(z − m) is kept in the registers and
// divided by the sum, as the plain version does. The max is fmaxf: a NaN
// logit still makes every output NaN, through its exp and the sum. Bound:
// bytes (the logits read and the probabilities written once) by the data
// sheet; on the card the exp, the IEEE division and the products cost
// ~30 instructions a value, so instruction throughput and latency hold
// it.
//
// The backward replaces the XLA code of the same file's custom VJP
// (pallas_kernels.py:_bwd): with gp = g_probs + g_x·xv + g_y·yv over a
// row, dz = p·(gp − Σ gp·p), written in the probabilities' dtype; g_probs
// may be null (treated as zeros). Bound: bytes (the probabilities, their
// gradient and dz, once each). The forward's design carried over: one
// block per row whose threads each hold two 16-byte vectors of it (8 bf16
// each) or four (4 f32 each), 400 threads at 80×80, so a training batch
// of 224 rows is on the card in one wave (up to three blocks an SM; one
// vector a thread, 800 threads, needs two blocks an SM and so 32
// registers, and spilled). The vectors of p and g_probs are read once, as
// 16-byte loads issued before the coordinate tables are staged, and kept
// packed in registers; gp comes from the same w + h tables in shared
// memory as the forward's (a vector inside one map row reads its xs as 16
// bytes and one ys). Each thread sums the f32 products gp·p per vector in
// f64, then one block reduction in f64 (warp shuffles, one shared step,
// warp shuffles over the warps' partials), rounded to f32 once: the row
// sum is the exact one, rounded, so dz moves from the plain version's only
// by the plain sum's own rounding, where a peaked row's gp − s cancels.
// Then dz is formed from the registers — gp recomputed, the same
// arithmetic — and written as 16-byte stores. Rows that are not a
// multiple of the vector, or whose base is not 16-byte aligned, go element
// by element with a masked tail; a row longer than the block's registers
// takes the rest from memory again in the second sweep.
#include <algorithm>

#include "common.cuh"

namespace mdcv {

constexpr int kMaxWarps = 32;

// values of a row each thread of the forward holds in registers, and its
// largest block (40 values need more than the 64 registers a thread of a
// 1024-thread block gets)
constexpr int kPerThread = 40;
constexpr int kMaxFwdThreads = 512;

// 16 bytes of logits ↔ f32
__device__ __forceinline__ void unpack16(const float* src, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(src);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* src, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[a]));
    v[2 * a] = f.x, v[2 * a + 1] = f.y;
  }
}
__device__ __forceinline__ void pack16(const float* v, float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void pack16(const float* v, __nv_bfloat16* dst) {
  uint32_t w[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * a], v[2 * a + 1]);  // round to nearest even
    w[a] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The row's vector j (elements j·V ... j·V + V − 1) into v; -inf past the
// row's end.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* z, int j, int hw, bool vec, float* v) {
  if (vec && (j + 1) * V <= hw) {
    unpack16(z + j * V, v);
    return;
  }
#pragma unroll
  for (int q = 0; q < V; ++q) v[q] = j * V + q < hw ? to_f32(z[j * V + q]) : -INFINITY;
}

// The row's vector j as its 16 packed bytes (V values of T); 0 past the
// row's end.
template <typename T, int V>
__device__ __forceinline__ uint4 load_raw(const T* z, int j, int hw, bool vec) {
  if (vec && (j + 1) * V <= hw) return __ldg(reinterpret_cast<const uint4*>(z + j * V));
  alignas(16) T t[V];
#pragma unroll
  for (int q = 0; q < V; ++q) t[q] = j * V + q < hw ? z[j * V + q] : from_f32<T>(0.f);
  return *reinterpret_cast<const uint4*>(t);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, int j, int hw, bool vec, const float* v) {
  if (vec && (j + 1) * V <= hw) {
    pack16(v, p + j * V);
    return;
  }
#pragma unroll
  for (int q = 0; q < V; ++q)
    if (j * V + q < hw) p[j * V + q] = from_f32<T>(v[q]);
}

// Σ p·xs[i % w] and Σ p·ys[i / w] over the vector's elements i = j·V + q
// below hw (tab: xs then ys)
template <int V>
__device__ __forceinline__ void add_coords(const float* p, int j, int hw, int w,
                                           const float* tab, float& ex, float& ey) {
  int r = (j * V) / w, c = j * V - r * w;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    if (j * V + q < hw) {
      ex += p[q] * tab[c];
      ey += p[q] * tab[w + r];
    }
    if (++c == w) c = 0, ++r;
  }
}

// Σ p·xs[c] and Σ p·ys[r] over a vector that lies in one map row r,
// from column c (a multiple of V: its xs are 16-byte aligned in `tab`)
template <int V>
__device__ __forceinline__ void add_coords_row(const float* p, int j, int w, const float* tab,
                                               float& ex, float& ey) {
  const int r = (j * V) / w, c = j * V - r * w;
  float x[V];
#pragma unroll
  for (int q = 0; q < V; q += 4) unpack16(tab + c + q, x + q);
  const float y = tab[w + r];
  float px = 0.f, py = 0.f;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    px += p[q] * x[q];
    py += p[q] * y;
  }
  ex += px;
  ey += py;
}

// Block-wide reductions: warp shuffles, then one shared step through
// `part` (one slot per warp, used by this reduction alone); every thread
// gets the result. blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_max_once(float v, float* part) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  float r = part[0];
  for (int a = 1; a < int(blockDim.x) / kWarp; ++a) r = fmaxf(r, part[a]);
  return r;
}
__device__ __forceinline__ float block_sum_once(float v, float* part) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  float r = 0.f;
  for (int a = 0; a < int(blockDim.x) / kWarp; ++a) r += part[a];
  return r;
}
__device__ __forceinline__ float2 block_sum2_once(float2 v, float2* part) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int a = 0; a < int(blockDim.x) / kWarp; ++a) r.x += part[a].x, r.y += part[a].y;
  return r;
}

// f64, and the warps' partials summed by the same xor shuffles in every
// warp (lane a holds warp a's, 0 past the last warp), not one after another
__device__ __forceinline__ double block_sum_f64_once(double v, double* part) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  const int lane = threadIdx.x % kWarp;
  double r = lane < int(blockDim.x) / kWarp ? part[lane] : 0.0;
  for (int o = kWarp / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
  return r;
}

// One row a block; each thread holds kPerThread values of it: the vectors
// j = a·blockDim + threadIdx (a < kPerThread / V), coalesced. Vectors past
// those (rows longer than blockDim·kPerThread) are read again per sweep.
// The max ignores NaN (fmaxf): a NaN logit makes its exp, and so the sum,
// every probability and both points NaN, as the plain version's NaN max
// does. Values past the row's end are -inf, whose exp adds 0 (or NaN to a
// sum that is NaN already: a row of -inf and NaN only).
template <typename T>
__global__ void __launch_bounds__(kMaxFwdThreads)
    softargmax_kernel(const T* __restrict__ logits, const float* __restrict__ xs,
                      const float* __restrict__ ys, T* __restrict__ probs,
                      float* __restrict__ pts, int h, int w) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = kPerThread / V;
  extern __shared__ __align__(16) float tab[];  // xs[0, w), then ys[0, h)
  __shared__ float part_max[kMaxWarps], part_sum[kMaxWarps];
  __shared__ float2 part_xy[kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x, hw = h * w;
  for (int i = tid; i < w; i += nt) tab[i] = xs[i];
  for (int i = tid; i < h; i += nt) tab[w + i] = ys[i];
  const size_t row = blockIdx.x;
  const T* z = logits + row * hw;
  T* p_out = probs + row * hw;
  // 16-byte access needs rows that start on 16 bytes
  const bool vec = hw % V == 0 && reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(probs) % 16 == 0;
  const bool in_row = vec && w % V == 0;  // every vector lies in one map row
  const int nvec = (hw + V - 1) / V;

  float v[NV][V];
  float m = -INFINITY;
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    const int j = a * nt + tid;
    if (j < nvec) {
      load_vec<T, V>(z, j, hw, vec, v[a]);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[a][q] = -INFINITY;
    }
    float mv = v[a][0];
#pragma unroll
    for (int q = 1; q < V; ++q) mv = fmaxf(mv, v[a][q]);
    m = fmaxf(m, mv);
  }
  for (int j = NV * nt + tid; j < nvec; j += nt) {
    float t[V];
    load_vec<T, V>(z, j, hw, vec, t);
#pragma unroll
    for (int q = 0; q < V; ++q) m = fmaxf(m, t[q]);
  }
  m = block_max_once(m, part_max);  // its barrier also publishes the tables

  float s = 0.f;
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    float sv = 0.f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      v[a][q] = expf(v[a][q] - m);
      sv += v[a][q];
    }
    s += sv;
  }
  for (int j = NV * nt + tid; j < nvec; j += nt) {
    float t[V];
    load_vec<T, V>(z, j, hw, vec, t);
    float sv = 0.f;
#pragma unroll
    for (int q = 0; q < V; ++q) sv += expf(t[q] - m);
    s += sv;
  }
  s = block_sum_once(s, part_sum);

  float ex = 0.f, ey = 0.f;
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    const int j = a * nt + tid;
    if (j < nvec) {
#pragma unroll
      for (int q = 0; q < V; ++q) v[a][q] = v[a][q] / s;
      store_vec<T, V>(p_out, j, hw, vec, v[a]);
      if (in_row)
        add_coords_row<V>(v[a], j, w, tab, ex, ey);
      else
        add_coords<V>(v[a], j, hw, w, tab, ex, ey);
    }
  }
  for (int j = NV * nt + tid; j < nvec; j += nt) {
    float t[V];
    load_vec<T, V>(z, j, hw, vec, t);
#pragma unroll
    for (int q = 0; q < V; ++q) t[q] = expf(t[q] - m) / s;
    store_vec<T, V>(p_out, j, hw, vec, t);
    if (in_row)
      add_coords_row<V>(t, j, w, tab, ex, ey);
    else
      add_coords<V>(t, j, hw, w, tab, ex, ey);
  }
  const float2 e = block_sum2_once(make_float2(ex, ey), part_xy);
  if (tid == 0) {
    pts[2 * row] = e.x;
    pts[2 * row + 1] = e.y;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const float* xs, const float* ys, void* probs, float* pts,
                   int M, int h, int w, cudaStream_t stream) {
  const int hw = h * w;
  const int want = (hw + kPerThread - 1) / kPerThread;
  const int threads = std::min(kMaxFwdThreads, (want + kWarp - 1) / kWarp * kWarp);
  softargmax_kernel<T><<<M, threads, (h + w) * sizeof(float), stream>>>(
      static_cast<const T*>(logits), xs, ys, static_cast<T*>(probs), pts, h, w);
  return cudaGetLastError();
}

// The backward's vectors a thread holds: two of bf16 (8 values each),
// four of f32 (4 each), 400 threads a row at 80×80; and its largest block
template <typename T> constexpr int kBwdVecs = sizeof(T) == 2 ? 2 : 4;
constexpr int kMaxBwdThreads = 1024;

// gp = g_probs + (g_x·xs[i % w] + g_y·ys[i / w]) for the vector's elements
// i = j·V + q below hw, as the plain version rounds it (without g_probs,
// the bracket alone); 0 past the end. tab: xs then ys
template <int V>
__device__ __forceinline__ void grad_vec(const float* gpr, bool has_g, int j, int hw, int w,
                                         bool in_row, const float* tab, float gx, float gy,
                                         float* gp) {
  int r = (j * V) / w, c = j * V - r * w;
  if (in_row) {  // one map row: xs[c, c + V) as 16-byte loads, one ys
    float x[V];
#pragma unroll
    for (int q = 0; q < V; q += 4) unpack16(tab + c + q, x + q);
    const float yy = gy * tab[w + r];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const float up = gx * x[q] + yy;
      gp[q] = has_g ? gpr[q] + up : up;
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < V; ++q) {
    gp[q] = 0.f;
    if (j * V + q < hw) {
      const float up = gx * tab[c] + gy * tab[w + r];
      gp[q] = has_g ? gpr[q] + up : up;
    }
    if (++c == w) c = 0, ++r;
  }
}

// One row a block; thread t holds the vectors j = a·blockDim + t (a <
// kBwdVecs), coalesced, as packed bytes. Vectors past those (rows longer
// than blockDim·kBwdVecs vectors) are read again in each sweep.
template <typename T>
__global__ void __launch_bounds__(kMaxBwdThreads)
    softargmax_bwd_kernel(const T* __restrict__ probs, const T* __restrict__ g_probs,
                          const float* __restrict__ g_pts, const float* __restrict__ xs,
                          const float* __restrict__ ys, T* __restrict__ dz, int h, int w) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NV = kBwdVecs<T>;
  extern __shared__ __align__(16) float tab[];  // xs[0, w), then ys[0, h)
  __shared__ double part[kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x, hw = h * w;
  const size_t row = blockIdx.x;
  const T* p = probs + row * hw;
  const T* gpr = g_probs ? g_probs + row * hw : nullptr;
  const bool has_g = gpr != nullptr;
  T* out = dz + row * hw;
  auto aligned = [](const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; };
  // 16-byte access needs rows that start on 16 bytes
  const bool vec = hw % V == 0 && aligned(probs) && aligned(dz) && (!g_probs || aligned(g_probs));
  const bool in_row = vec && w % V == 0;  // every vector lies in one map row
  const int nvec = (hw + V - 1) / V;

  uint4 pr[NV], gr[NV];
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    const int j = a * nt + tid;
    pr[a] = gr[a] = make_uint4(0, 0, 0, 0);  // zeros in either dtype
    if (j < nvec) {
      pr[a] = load_raw<T, V>(p, j, hw, vec);
      if (gpr) gr[a] = load_raw<T, V>(gpr, j, hw, vec);
    }
  }
  for (int i = tid; i < w; i += nt) tab[i] = xs[i];
  for (int i = tid; i < h; i += nt) tab[w + i] = ys[i];
  const float gx = g_pts[2 * row], gy = g_pts[2 * row + 1];
  __syncthreads();

  // Σ gp·p of the f32 products, in f64: per vector, then over the thread's
  // vectors, then the block; rounded to f32 once
  double s = 0.0;
  float pv[V], gv[V], gp[V];
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    const int j = a * nt + tid;
    if (j < nvec) {
      unpack16(reinterpret_cast<const T*>(&pr[a]), pv);
      unpack16(reinterpret_cast<const T*>(&gr[a]), gv);
      grad_vec<V>(gv, has_g, j, hw, w, in_row, tab, gx, gy, gp);
      double sv = 0.0;
#pragma unroll
      for (int q = 0; q < V; ++q) sv += double(gp[q] * pv[q]);
      s += sv;
    }
  }
  for (int j = NV * nt + tid; j < nvec; j += nt) {
    const uint4 pj = load_raw<T, V>(p, j, hw, vec);
    const uint4 g = gpr ? load_raw<T, V>(gpr, j, hw, vec) : make_uint4(0, 0, 0, 0);
    unpack16(reinterpret_cast<const T*>(&pj), pv);
    unpack16(reinterpret_cast<const T*>(&g), gv);
    grad_vec<V>(gv, has_g, j, hw, w, in_row, tab, gx, gy, gp);
    double sv = 0.0;
#pragma unroll
    for (int q = 0; q < V; ++q) sv += double(gp[q] * pv[q]);
    s += sv;
  }
  const float sum = float(block_sum_f64_once(s, part));

  // dz = p·(gp − s)
#pragma unroll
  for (int a = 0; a < NV; ++a) {
    const int j = a * nt + tid;
    if (j < nvec) {
      unpack16(reinterpret_cast<const T*>(&pr[a]), pv);
      unpack16(reinterpret_cast<const T*>(&gr[a]), gv);
      grad_vec<V>(gv, has_g, j, hw, w, in_row, tab, gx, gy, gp);
#pragma unroll
      for (int q = 0; q < V; ++q) gp[q] = pv[q] * (gp[q] - sum);
      store_vec<T, V>(out, j, hw, vec, gp);
    }
  }
  for (int j = NV * nt + tid; j < nvec; j += nt) {
    const uint4 pj = load_raw<T, V>(p, j, hw, vec);
    const uint4 g = gpr ? load_raw<T, V>(gpr, j, hw, vec) : make_uint4(0, 0, 0, 0);
    unpack16(reinterpret_cast<const T*>(&pj), pv);
    unpack16(reinterpret_cast<const T*>(&g), gv);
    grad_vec<V>(gv, has_g, j, hw, w, in_row, tab, gx, gy, gp);
#pragma unroll
    for (int q = 0; q < V; ++q) gp[q] = pv[q] * (gp[q] - sum);
    store_vec<T, V>(out, j, hw, vec, gp);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* probs, const void* g_probs, const float* g_pts,
                       const float* xs, const float* ys, void* dz, int M, int h, int w,
                       cudaStream_t stream) {
  const int nvec = (h * w + 16 / int(sizeof(T)) - 1) / (16 / int(sizeof(T)));
  const int want = (nvec + kBwdVecs<T> - 1) / kBwdVecs<T>;
  const int threads = std::min(kMaxBwdThreads, (want + kWarp - 1) / kWarp * kWarp);
  softargmax_bwd_kernel<T><<<M, threads, (h + w) * sizeof(float), stream>>>(
      static_cast<const T*>(probs), static_cast<const T*>(g_probs), g_pts, xs, ys,
      static_cast<T*>(dz), h, w);
  return cudaGetLastError();
}

}  // namespace mdcv

extern "C" int mdcv_softargmax_bwd(const void* probs, const void* g_probs, const void* g_pts,
                                   const void* xs, const void* ys, void* dz, int M, int h,
                                   int w, int dtype, void* stream) {
  if (M == 0) return 0;
  // the tables must fit the 48 KB of shared memory a launch gets unasked
  if (h < 1 || w < 1 || h + w > 10240) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto g = static_cast<const float*>(g_pts);
  auto x = static_cast<const float*>(xs);
  auto y = static_cast<const float*>(ys);
  if (dtype == 0) return mdcv::launch_bwd<float>(probs, g_probs, g, x, y, dz, M, h, w, s);
  if (dtype == 1)
    return mdcv::launch_bwd<__nv_bfloat16>(probs, g_probs, g, x, y, dz, M, h, w, s);
  return int(cudaErrorInvalidValue);
}

extern "C" int mdcv_softargmax(const void* logits, const void* xs, const void* ys, void* probs,
                               void* pts, int M, int h, int w, int dtype, void* stream) {
  if (M == 0) return 0;
  // the tables must fit the 48 KB of shared memory a launch gets unasked
  if (h < 1 || w < 1 || h + w > 10240) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xs);
  auto y = static_cast<const float*>(ys);
  auto p = static_cast<float*>(pts);
  if (dtype == 0) return mdcv::launch<float>(logits, x, y, probs, p, M, h, w, s);
  if (dtype == 1) return mdcv::launch<__nv_bfloat16>(logits, x, y, probs, p, M, h, w, s);
  return int(cudaErrorInvalidValue);
}
