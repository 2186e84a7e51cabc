// K4 — the fused int8 entry block: conv2p → 1×1 → 3×3 → shortcut → requant.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_entry.py:fused_entry_block (body _entry_kernel). For each image,
// hq (H, W, 128 int8) becomes resq (H, W, 64 int8), Darknet blocks 1-4:
//
//   out2 = leaky(deq(conv2p(hq)))            2×2 taps, pad top/left 1, 128→64
//   t    = leaky(deq(1×1(q8(out2))))          64→32, zero outside the frame
//   b3   = leaky(deq(3×3(q8(t))))             pad 1, 32→64
//   resq = q8(b3 + out2)                      the shortcut add in bf16
//
// with the rounding points of ops/entry.py:_entry_rest, its plain version,
// which this kernel equals bit for bit: int32 sums (__dp4a over channel
// quads); acc·scale then +b as two f32 roundings (-fmad=false keeps them
// apart); a bf16 cast; leaky with the slope already rounded to bf16 (the
// product of two bf16 values is exact in f32, so it rounds once);
// requant = clamp(rintf(x·sx_inv), -127, 127), rintf rounding half to even.
//
// On the card: one block of 512 threads per (16×16 output tile, image).
// The TPU kernel's 16-row bands, scratch layout and rank-3 dots were
// Mosaic constraints and are not copied. A tile reads a 19×19 hq window
// (halo 2 above/left, 1 below/right, zeros outside the frame), computes
// out2 and t on the 18×18 ring around the tile (halos recomputed by the
// neighbours), then the 16×16 outputs; everything stays in shared memory:
// weights 52 KB (laid out once by ops/entry.py:pack_entry so that one
// 16-byte load holds 16 input channels of one output channel), hq 45 KB (reused for q8(out2)
// and q8(t) once conv2p is done), out2 in bf16 40.5 KB. In each product a
// lane owns output channels lane and lane + 32 and a warp walks four
// positions at a time: one broadcast load of 16 activation bytes feeds
// eight __dp4a. Bound: the int8 dot products — 4.0 M __dp4a per tile, as
// CUDA-core integer math (the tensor cores, wgmma and TMA are later work).
#include <atomic>

#include "common.cuh"

namespace mdcv {

constexpr int kTile = 16;              // output rows and columns per block
constexpr int kHq = kTile + 3;         // 19: hq window side
constexpr int kMid = kTile + 2;        // 18: out2 / t side
constexpr int kCin = 128, kC2 = 64, kCt = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;
constexpr int kQuad = 4;               // positions per warp step

constexpr int kW2Bytes = 4 * kCin * kC2;            // [tap 4][c16 8][n 64][16]
constexpr int kW1Bytes = kC2 * kCt;                 // [c16 4][m 32][16]
constexpr int kW3Bytes = 9 * kCt * kC2;             // [tap 9][c16 2][n 64][16]
constexpr int kHqBytes = kHq * kHq * kCin;          // then q8(out2), q8(t)
constexpr int kOut2Bytes = kMid * kMid * kC2 * 2;   // bf16
constexpr int kQ2Bytes = kMid * kMid * kC2;
constexpr int kOffW1 = kW2Bytes;
constexpr int kOffW3 = kOffW1 + kW1Bytes;
constexpr int kOffHq = kOffW3 + kW3Bytes;
constexpr int kOffOut2 = kOffHq + kHqBytes;
constexpr int kSmem = kOffOut2 + kOut2Bytes;        // 140,928 bytes
static_assert(kQ2Bytes + kMid * kMid * kCt <= kHqBytes, "q8 buffers overflow hq");
static_assert(kOffHq % 16 == 0 && kOffOut2 % 16 == 0 && kQ2Bytes % 16 == 0,
              "16-byte alignment of the shared buffers");
static_assert((kMid * kMid) % kQuad == 0 && (kTile * kTile) % kQuad == 0, "quads");

__device__ __forceinline__ int dot16(const int4 a, const int4 w, int acc) {
  acc = __dp4a(a.x, w.x, acc);
  acc = __dp4a(a.y, w.y, acc);
  acc = __dp4a(a.z, w.z, acc);
  return __dp4a(a.w, w.w, acc);
}

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

__global__ void __launch_bounds__(kThreads, 1)
    entry_block_kernel(const int8_t* __restrict__ hq, const int4* __restrict__ w2p,
                       const float* __restrict__ w2s, const float* __restrict__ w2b,
                       const int4* __restrict__ w1p, const float* __restrict__ w1s,
                       const float* __restrict__ w1b, const int4* __restrict__ w3p,
                       const float* __restrict__ w3s, const float* __restrict__ w3b,
                       const float* __restrict__ sx, int8_t* __restrict__ out, int H, int W,
                       float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* sW2 = reinterpret_cast<int4*>(smem);
  int4* sW1 = reinterpret_cast<int4*>(smem + kOffW1);
  int4* sW3 = reinterpret_cast<int4*>(smem + kOffW3);
  int4* sHq = reinterpret_cast<int4*>(smem + kOffHq);           // [19·19][8]
  int4* sQ2 = sHq;                                              // [18·18][4]
  int4* sT = reinterpret_cast<int4*>(smem + kOffHq + kQ2Bytes); // [18·18][2]
  __nv_bfloat16* sOut2 = reinterpret_cast<__nv_bfloat16*>(smem + kOffOut2);

  const int c0 = blockIdx.x * kTile, r0 = blockIdx.y * kTile;
  const size_t img = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int n0 = lane, n1 = lane + kWarp;  // this lane's output channels

  for (int i = tid; i < kW2Bytes / 16; i += kThreads) sW2[i] = w2p[i];
  for (int i = tid; i < kW1Bytes / 16; i += kThreads) sW1[i] = w1p[i];
  for (int i = tid; i < kW3Bytes / 16; i += kThreads) sW3[i] = w3p[i];
  const int8_t* src = hq + img * H * W * kCin;
  for (int i = tid; i < kHq * kHq * (kCin / 16); i += kThreads) {
    const int pos = i / (kCin / 16), chunk = i % (kCin / 16);
    const int y = r0 - 2 + pos / kHq, x = c0 - 2 + pos % kHq;
    int4 v = make_int4(0, 0, 0, 0);
    if (y >= 0 && y < H && x >= 0 && x < W)
      v = *reinterpret_cast<const int4*>(src + (size_t(y) * W + x) * kCin + chunk * 16);
    sHq[i] = v;
  }
  __syncthreads();

  // ---- conv2p on the 18×18 ring: out2 (pos p ↔ frame (r0-1+p/18, c0-1+p%18))
  {
    const float sa = w2s[n0], sb = w2s[n1], ba = w2b[n0], bb = w2b[n1];
    for (int p0 = warp * kQuad; p0 < kMid * kMid; p0 += kWarps * kQuad) {
      int acc[kQuad][2] = {};
      int base[kQuad];
#pragma unroll
      for (int k = 0; k < kQuad; ++k) base[k] = ((p0 + k) / kMid) * kHq + (p0 + k) % kMid;
#pragma unroll
      for (int t = 0; t < 4; ++t) {  // tap (Dy, Dx) = (t/2, t%2) reads hq (p-1+Dy, q-1+Dx)
        const int toff = (t / 2) * kHq + t % 2;
#pragma unroll 2
        for (int c16 = 0; c16 < kCin / 16; ++c16) {
          const int4 wa = sW2[(t * 8 + c16) * kC2 + n0];
          const int4 wb = sW2[(t * 8 + c16) * kC2 + n1];
#pragma unroll
          for (int k = 0; k < kQuad; ++k) {
            const int4 a = sHq[(base[k] + toff) * (kCin / 16) + c16];
            acc[k][0] = dot16(a, wa, acc[k][0]);
            acc[k][1] = dot16(a, wb, acc[k][1]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        sOut2[(p0 + k) * kC2 + n0] = deq_leaky(acc[k][0], sa, ba, slope);
        sOut2[(p0 + k) * kC2 + n1] = deq_leaky(acc[k][1], sb, bb, slope);
      }
    }
  }
  __syncthreads();  // hq is dead from here: its space holds q8(out2), q8(t)

  {
    const float s0 = sx[0];
    char4* q2 = reinterpret_cast<char4*>(sQ2);
    for (int i = tid; i < kQ2Bytes / 4; i += kThreads) {
      const __nv_bfloat16* v = sOut2 + i * 4;
      q2[i] = make_char4(q8(__bfloat162float(v[0]), s0), q8(__bfloat162float(v[1]), s0),
                         q8(__bfloat162float(v[2]), s0), q8(__bfloat162float(v[3]), s0));
    }
  }
  __syncthreads();

  // ---- 1×1 64→32 on the ring: t, zero outside the frame, quantized
  {
    const float s = w1s[lane], bi = w1b[lane], s1 = sx[1];
    int8_t* tq = reinterpret_cast<int8_t*>(sT);
    for (int p0 = warp * kQuad; p0 < kMid * kMid; p0 += kWarps * kQuad) {
      int acc[kQuad] = {};
#pragma unroll
      for (int c16 = 0; c16 < kC2 / 16; ++c16) {
        const int4 w = sW1[c16 * kCt + lane];
#pragma unroll
        for (int k = 0; k < kQuad; ++k) acc[k] = dot16(sQ2[(p0 + k) * 4 + c16], w, acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        const int p = p0 + k;
        const int y = r0 - 1 + p / kMid, x = c0 - 1 + p % kMid;
        int8_t v = 0;
        if (y >= 0 && y < H && x >= 0 && x < W)
          v = q8(__bfloat162float(deq_leaky(acc[k], s, bi, slope)), s1);
        tq[p * kCt + lane] = v;
      }
    }
  }
  __syncthreads();

  // ---- 3×3 32→64 on the tile, shortcut add, requant, store
  {
    const float sa = w3s[n0], sb = w3s[n1], ba = w3b[n0], bb = w3b[n1], s2 = sx[2];
    int8_t* dst = out + img * H * W * kC2;
    for (int p0 = warp * kQuad; p0 < kTile * kTile; p0 += kWarps * kQuad) {
      int acc[kQuad][2] = {};
      int base[kQuad];
#pragma unroll
      for (int k = 0; k < kQuad; ++k) base[k] = ((p0 + k) / kTile) * kMid + (p0 + k) % kTile;
#pragma unroll 3
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * kMid + tap % 3;
#pragma unroll
        for (int c16 = 0; c16 < kCt / 16; ++c16) {
          const int4 wa = sW3[(tap * 2 + c16) * kC2 + n0];
          const int4 wb = sW3[(tap * 2 + c16) * kC2 + n1];
#pragma unroll
          for (int k = 0; k < kQuad; ++k) {
            const int4 a = sT[(base[k] + toff) * 2 + c16];
            acc[k][0] = dot16(a, wa, acc[k][0]);
            acc[k][1] = dot16(a, wb, acc[k][1]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQuad; ++k) {
        const int iy = (p0 + k) / kTile, ix = (p0 + k) % kTile;
        const __nv_bfloat16* o2 = sOut2 + ((iy + 1) * kMid + ix + 1) * kC2;
        const float ra = __bfloat162float(deq_leaky(acc[k][0], sa, ba, slope)) +
                         __bfloat162float(o2[n0]);
        const float rb = __bfloat162float(deq_leaky(acc[k][1], sb, bb, slope)) +
                         __bfloat162float(o2[n1]);
        int8_t* d = dst + (size_t(r0 + iy) * W + c0 + ix) * kC2;
        d[n0] = q8(__bfloat162float(__float2bfloat16_rn(ra)), s2);
        d[n1] = q8(__bfloat162float(__float2bfloat16_rn(rb)), s2);
      }
    }
  }
}

}  // namespace mdcv

extern "C" int mdcv_entry_block(const void* hq, const void* w2p, const void* w2s,
                                const void* w2b, const void* w1p, const void* w1s,
                                const void* w1b, const void* w3p, const void* w3s,
                                const void* w3b, const void* sx, void* out, int B, int H,
                                int W, float slope, int dtype, void* stream) {
  if (dtype != 2 || H <= 0 || W <= 0 || H % mdcv::kTile || W % mdcv::kTile)
    return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  // the 140 KB of dynamic shared memory needs an opt-in, once per device
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(mdcv::entry_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, mdcv::kSmem);
    if (e != cudaSuccess) return int(e);
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(W / mdcv::kTile, H / mdcv::kTile, B);
  mdcv::entry_block_kernel<<<grid, mdcv::kThreads, mdcv::kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const int4*>(w2p),
      static_cast<const float*>(w2s), static_cast<const float*>(w2b),
      static_cast<const int4*>(w1p), static_cast<const float*>(w1s),
      static_cast<const float*>(w1b), static_cast<const int4*>(w3p),
      static_cast<const float*>(w3s), static_cast<const float*>(w3b),
      static_cast<const float*>(sx), static_cast<int8_t*>(out), H, W, slope);
  return int(cudaGetLastError());
}
