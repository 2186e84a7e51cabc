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
// which this kernel equals bit for bit: exact int32 sums; acc·scale then
// +b as two f32 roundings (-fmad=false keeps them apart); a bf16 cast;
// leaky with the slope already rounded to bf16 (the product of two bf16
// values is exact in f32, so it rounds once); requant = clamp(rintf(x·
// sx_inv), -127, 127), rintf rounding half to even.
//
// Bound: the int8 products, 36.9 G multiply-adds·2 at (8, 208, 208, 128)
// (about 47 G with the halos each tile recomputes), against 1,979 TOP/s of
// the int8 tensor cores; the bytes (hq in, resq out, 29 MB) take 8.8 µs.
// The design runs the three convolutions as implicit GEMMs per 16×16 output
// tile on the tensor cores (s8·s8→s32; sums of at most 512 products of
// |127|² cannot overflow, so they are the same integers in any order):
//
//   conv2p  M = 324 ring positions (18×18), K = 4·128, N = 64   wgmma m64n32k32
//   1×1     M = 324,                        K = 64,    N = 32   mma.sync m16n8k32
//   3×3     M = 256 (4 output rows an m64), K = 9·32,  N = 64   wgmma m64n32k32
//
// A comes from shared memory by ldmatrix into registers, each lane pointing
// at its own row, so the im2col is addressing only; the A layouts are
// XOR-swizzled in 16-byte chunks so that the eight rows of an 8×8 matrix
// fall in eight bank groups (hq: 128 B a position, chunk ^= pos & 7;
// q8(out2): 64 B, chunk ^= (pos >> 1) & 3; q8(t): 32 B, chunk ^= (pos >> 2)
// & 1). ops/entry.py:pack_entry lays B out once as the kernel reads it: for
// wgmma, K-major 8×16-byte core matrices that a shared-memory descriptor
// names (conv2p, 3×3); for mma.sync, each lane's fragment registers (1×1).
// A warpgroup's job is one m64 tile against half of N; the 1×1's job is one
// m-tile of 16 against 16 channels, 42 of them over 16 warps.
//
// Persistent blocks: one block of 512 threads per SM walks over the (image,
// tile) pairs; it loads the 52 KB of weights once, and prefetches the next
// tile's 19×19×128 hq window with cp.async into a second buffer while it
// computes the current one. Shared memory: weights 52 KB, 2 × 45 KB of hq,
// out2 in bf16 on the 16×16 interior 32 KB (the ring's halo only feeds the
// 1×1, as q8), q8(out2) 20 KB (reused to stage the output tile, stored
// with 16-byte writes), q8(t) 10 KB, scales 1.3 KB: 206 KB of 227.
//
// What bounds it now (clock64 phases of a patched copy, H100 80GB HBM3 at 700 W): a
// tile's cycles go to conv2p 45%, the 1×1 17%, the 3×3 26%, the window
// wait 8% and the output copy 3%. The same kernel without its epilogues
// (about 47k values a tile dequantized, leaky'd and requantized on the CUDA
// cores) takes three quarters of the time; the rest is the products with
// their ldmatrix loads of A, which neither mma.sync in place of wgmma nor
// m64n64 in place of m64n32 made faster, and a barrier after each phase.
#include <atomic>

#include "int8_mma.cuh"

namespace mdcv {

constexpr int kTile = 16;              // output rows and columns per tile
constexpr int kHq = kTile + 3;         // 19: hq window side
constexpr int kMid = kTile + 2;        // 18: out2 / t side (the ring)
constexpr int kRing = kMid * kMid;     // 324
constexpr int kRingTiles = (kRing + 15) / 16;  // 21
constexpr int kCin = 128, kC2 = 64, kCt = 32;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / kWarp;

// packed B: conv2p and 3×3 as wgmma tiles [k-step][n-half][n-group 4]
// [k-chunk 2][8 rows][16 bytes], 1 KB each; the 1×1 as mma.sync fragments
// [k-step][pair q][lane][16 bytes]
constexpr int kW2Bytes = 16 * 2 * 1024;        // K 512 = 16 k-steps, N 64
constexpr int kW1Bytes = 2 * 2 * 32 * 16;      // K 64, N 32
constexpr int kW3Bytes = 9 * 2 * 1024;         // K 288, N 64
constexpr int kHqBytes = kHq * kHq * kCin;
constexpr int kOut2Bytes = kTile * kTile * kC2 * 2;  // bf16, interior only
constexpr int kQ2Bytes = kRing * kC2;
constexpr int kTBytes = kRing * kCt;
constexpr int kParams = 2 * kC2 + 2 * kCt + 2 * kC2 + 4;  // scales, biases, sx

constexpr int kOffW1 = kW2Bytes;
constexpr int kOffW3 = kOffW1 + kW1Bytes;
constexpr int kOffHq = kOffW3 + kW3Bytes;
constexpr int kOffOut2 = kOffHq + 2 * kHqBytes;
constexpr int kOffQ2 = kOffOut2 + kOut2Bytes;
constexpr int kOffT = kOffQ2 + kQ2Bytes;
constexpr int kOffPar = kOffT + kTBytes;
constexpr int kSmem = kOffPar + kParams * 4;  // 210,832 bytes
static_assert(kSmem <= 232448, "shared memory");
static_assert(kHqBytes % 16 == 0 && kOffHq % 16 == 0 && kOffOut2 % 16 == 0 &&
                  kOffQ2 % 16 == 0 && kOffT % 16 == 0 && kOffPar % 16 == 0,
              "16-byte alignment of the shared buffers");
static_assert(kTile * kTile * kC2 <= kQ2Bytes, "the output tile is staged in q8(out2)");

struct TileAt {
  int img, r0, c0;
};

__device__ __forceinline__ TileAt tile_at(int t, int tiles_y, int tiles_x) {
  const int per = tiles_y * tiles_x, rem = t % per;
  return {t / per, (rem / tiles_x) * kTile, (rem % tiles_x) * kTile};
}

// the 19×19×128 hq window of a tile (origin 2 above and left of it, zeros
// outside the frame), swizzled, by cp.async
__device__ __forceinline__ void load_window(const int8_t* __restrict__ hq, unsigned char* buf,
                                            TileAt tl, int H, int W) {
  const int8_t* src = hq + size_t(tl.img) * H * W * kCin;
  for (int i = threadIdx.x; i < kHq * kHq * (kCin / 16); i += kThreads) {
    const int pos = i >> 3, chunk = i & 7;
    const int y = tl.r0 - 2 + pos / kHq, x = tl.c0 - 2 + pos % kHq;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int8_t* g = in ? src + (size_t(y) * W + x) * kCin + chunk * 16 : src;
    cp_async16(buf + pos * kCin + ((chunk ^ (pos & 7)) << 4), g, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    entry_block_kernel(const int8_t* __restrict__ hq, const int4* __restrict__ w2p,
                       const float* __restrict__ w2s, const float* __restrict__ w2b,
                       const int4* __restrict__ w1p, const float* __restrict__ w1s,
                       const float* __restrict__ w1b, const int4* __restrict__ w3p,
                       const float* __restrict__ w3s, const float* __restrict__ w3b,
                       const float* __restrict__ sx, int8_t* __restrict__ out, int H, int W,
                       int tiles, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned char* sW2b = smem;            // wgmma B tiles, 1 KB each
  const unsigned char* sW3b = smem + kOffW3;
  const int4* sW1 = reinterpret_cast<const int4*>(smem + kOffW1);
  __nv_bfloat16* sOut2 = reinterpret_cast<__nv_bfloat16*>(smem + kOffOut2);
  int8_t* sQ2 = reinterpret_cast<int8_t*>(smem + kOffQ2);
  int8_t* sT = reinterpret_cast<int8_t*>(smem + kOffT);
  float* par = reinterpret_cast<float*>(smem + kOffPar);
  float *p2s = par, *p2b = par + kC2, *p1s = par + 2 * kC2, *p1b = p1s + kCt;
  float *p3s = p1b + kCt, *p3b = p3s + kC2, *psx = p3b + kC2;

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wg = warp >> 2, wl = warp & 3;                    // warpgroup, warp in it
  const int g = lane >> 2, t4 = lane & 3;                     // C-fragment row, column pair
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;        // ldmatrix row
  const int ahalf = lane >> 4;                                // ldmatrix 16-byte half
  const int tiles_y = H / kTile, tiles_x = W / kTile;

  for (int i = tid; i < kW2Bytes / 16; i += kThreads) cp_async16(smem + i * 16, w2p + i, 16);
  for (int i = tid; i < kW1Bytes / 16; i += kThreads)
    cp_async16(smem + kOffW1 + i * 16, w1p + i, 16);
  for (int i = tid; i < kW3Bytes / 16; i += kThreads)
    cp_async16(smem + kOffW3 + i * 16, w3p + i, 16);
  for (int i = tid; i < kC2; i += kThreads) {
    p2s[i] = w2s[i], p2b[i] = w2b[i], p3s[i] = w3s[i], p3b[i] = w3b[i];
    if (i < kCt) p1s[i] = w1s[i], p1b[i] = w1b[i];
    if (i < 3) psx[i] = sx[i];
  }
  int buf = 0;
  if (blockIdx.x < tiles) load_window(hq, smem + kOffHq, tile_at(blockIdx.x, tiles_y, tiles_x), H, W);
  cp_async_commit();

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileAt tl = tile_at(t, tiles_y, tiles_x);
    if (t + gridDim.x < tiles)
      load_window(hq, smem + kOffHq + (buf ^ 1) * kHqBytes,
                  tile_at(t + gridDim.x, tiles_y, tiles_x), H, W);
    cp_async_commit();
    cp_async_wait1();  // this tile's window (and, first, the weights) landed
    // the weights, written by cp.async, are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const unsigned char* sHq = smem + kOffHq + buf * kHqBytes;
    const float sx0 = psx[0], sx1 = psx[1], sx2 = psx[2];

    // ---- conv2p on the ring: ring pos p ↔ frame (r0-1+p/18, c0-1+p%18);
    // tap (Dy, Dx) = (tap/2, tap%2) reads the window at (p/18+Dy, p%18+Dx)
    // a job: one m64 tile of ring rows against one n-half, per warpgroup
    // (wgmma); this warp's 16 rows are m-tile 4·m64 + wl
    for (int job = wg; job < 12; job += kWarps / 4) {
      const int mt = (job >> 1) * 4 + wl, h = job & 1;
      const int pa = min(mt * 16 + arow, kRing - 1);
      const int base = (pa / kMid) * kHq + pa % kMid;
      uint32_t a[16][4];
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        const int tap = s >> 2, pos = base + (tap >> 1) * kHq + (tap & 1);
        const int chunk = (s & 3) * 2 + ahalf;
        ldmatrix_x4(smem_u32(sHq + pos * kCin + ((chunk ^ (pos & 7)) << 4)), a[s]);
      }
      int acc[4][4] = {};
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 16; ++s) wgmma_n32(acc, a[s], kmajor_desc(sW2b + (s * 2 + h) * 1024), s);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int s = 0; s < 16; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) keep(a[s][k]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) keep(acc[nt][k]);
      // this lane's channels: n0 + 8·nt and the next one
      const int n0 = h * 32 + t4 * 2;
      float2 sc[4], bi[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt] = *reinterpret_cast<const float2*>(p2s + n0 + nt * 8);
        bi[nt] = *reinterpret_cast<const float2*>(p2b + n0 + nt * 8);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = mt * 16 + g + rr * 8;
        if (p >= kRing) continue;
        const int py = p / kMid, px = p - py * kMid;
        const bool interior = py >= 1 && py <= kTile && px >= 1 && px <= kTile;
        int8_t* q2 = sQ2 + p * kC2;
        const int sw = (p >> 1) & 3;
        __nv_bfloat16* o2 = sOut2 + ((py - 1) * kTile + px - 1) * kC2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + nt * 8;
          const __nv_bfloat16 v0 = deq_leaky(acc[nt][rr * 2], sc[nt].x, bi[nt].x, slope);
          const __nv_bfloat16 v1 = deq_leaky(acc[nt][rr * 2 + 1], sc[nt].y, bi[nt].y, slope);
          *reinterpret_cast<char2*>(q2 + (((n >> 4) ^ sw) << 4) + (n & 15)) =
              make_char2(q8(__bfloat162float(v0), sx0), q8(__bfloat162float(v1), sx0));
          if (interior) {
            __nv_bfloat162 v;
            v.x = v0, v.y = v1;
            *reinterpret_cast<__nv_bfloat162*>(o2 + n) = v;
          }
        }
      }
    }
    __syncthreads();

    // ---- 1×1 64→32 on the ring: t, zero outside the frame, quantized
    // a job: one m-tile against one 16-channel half (mma.sync), 42 jobs
    for (int job = warp; job < 2 * kRingTiles; job += kWarps) {
      const int mt = job >> 1, hb = job & 1;
      const int pa = min(mt * 16 + arow, kRing - 1);
      int acc[2][4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int chunk = s * 2 + ahalf;
        uint32_t a[4];
        ldmatrix_x4(smem_u32(sQ2 + pa * kC2 + ((chunk ^ ((pa >> 1) & 3)) << 4)), a);
        const int4 w = sW1[(s * 2 + hb) * 32 + lane];  // n-tiles 2hb, 2hb + 1
        mma_s8(acc[0], a, w.x, w.y);
        mma_s8(acc[1], a, w.z, w.w);
      }
      const int n0 = hb * 16 + t4 * 2;
      float2 sc[2], bi[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        sc[nt] = *reinterpret_cast<const float2*>(p1s + n0 + nt * 8);
        bi[nt] = *reinterpret_cast<const float2*>(p1b + n0 + nt * 8);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int p = mt * 16 + g + rr * 8;
        if (p >= kRing) continue;
        const int py = p / kMid, px = p - py * kMid;
        const int y = tl.r0 - 1 + py, x = tl.c0 - 1 + px;
        const bool inside = y >= 0 && y < H && x >= 0 && x < W;
        int8_t* tq = sT + p * kCt + (((n0 >> 4) ^ ((p >> 2) & 1)) << 4);  // one chunk
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = n0 + nt * 8;
          char2 v = make_char2(0, 0);
          if (inside)
            v = make_char2(
                q8(__bfloat162float(deq_leaky(acc[nt][rr * 2], sc[nt].x, bi[nt].x, slope)), sx1),
                q8(__bfloat162float(deq_leaky(acc[nt][rr * 2 + 1], sc[nt].y, bi[nt].y, slope)),
                   sx1));
          *reinterpret_cast<char2*>(tq + (n & 15)) = v;
        }
      }
    }
    __syncthreads();

    // ---- 3×3 32→64 on the tile (m-tile = output row iy), shortcut add,
    // requant; the int8 tile is staged in q8(out2)'s space
    int8_t* stage = sQ2;
    // a job: one m64 tile (four output rows) against one n-half, per
    // warpgroup (wgmma); this warp's row is iy = 4·m64 + wl
    for (int job = wg; job < 8; job += kWarps / 4) {
      const int iy = (job >> 1) * 4 + wl, h = job & 1;
      uint32_t a[9][4];
#pragma unroll
      for (int s = 0; s < 9; ++s) {  // tap (dy, dx) = (s/3, s%3)
        const int pos = (iy + s / 3) * kMid + arow + s % 3;
        ldmatrix_x4(smem_u32(sT + pos * kCt + ((ahalf ^ ((pos >> 2) & 1)) << 4)), a[s]);
      }
      int acc[4][4] = {};
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 9; ++s) wgmma_n32(acc, a[s], kmajor_desc(sW3b + (s * 2 + h) * 1024), s);
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int s = 0; s < 9; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) keep(a[s][k]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) keep(acc[nt][k]);
      const int n0 = h * 32 + t4 * 2;
      float2 sc[4], bi[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt] = *reinterpret_cast<const float2*>(p3s + n0 + nt * 8);
        bi[nt] = *reinterpret_cast<const float2*>(p3b + n0 + nt * 8);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int q = iy * kTile + g + rr * 8;  // interior position
        const __nv_bfloat16* o2 = sOut2 + q * kC2;
        int8_t* st = stage + q * kC2;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = n0 + nt * 8;
          const __nv_bfloat162 r2 = *reinterpret_cast<const __nv_bfloat162*>(o2 + n);
          const float ra =
              __bfloat162float(deq_leaky(acc[nt][rr * 2], sc[nt].x, bi[nt].x, slope)) +
              __bfloat162float(r2.x);
          const float rb =
              __bfloat162float(deq_leaky(acc[nt][rr * 2 + 1], sc[nt].y, bi[nt].y, slope)) +
              __bfloat162float(r2.y);
          *reinterpret_cast<char2*>(st + n) =
              make_char2(q8(__bfloat162float(__float2bfloat16_rn(ra)), sx2),
                         q8(__bfloat162float(__float2bfloat16_rn(rb)), sx2));
        }
      }
    }
    __syncthreads();
    // each output row of the tile is 16·64 contiguous bytes
    for (int i = tid; i < kTile * kTile * kC2 / 16; i += kThreads) {
      const int iy = i / (kTile * kC2 / 16), k = i % (kTile * kC2 / 16);
      int4* dst = reinterpret_cast<int4*>(
          out + ((size_t(tl.img) * H + tl.r0 + iy) * W + tl.c0) * kC2);
      dst[k] = reinterpret_cast<const int4*>(stage)[i];
    }
    buf ^= 1;
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
  // the 206 KB of dynamic shared memory needs an opt-in, and the grid is
  // one block per SM: both once per device
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  int n_sm = sms[dev].load(std::memory_order_acquire);
  if (n_sm == 0) {
    e = cudaFuncSetAttribute(mdcv::entry_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, mdcv::kSmem);
    if (e != cudaSuccess) return int(e);
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return int(e);
    sms[dev].store(n_sm, std::memory_order_release);
  }
  const long long tiles = (long long)B * (H / mdcv::kTile) * (W / mdcv::kTile);
  if (tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const int grid = tiles < n_sm ? int(tiles) : n_sm;
  mdcv::entry_block_kernel<<<grid, mdcv::kThreads, mdcv::kSmem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const int4*>(w2p),
      static_cast<const float*>(w2s), static_cast<const float*>(w2b),
      static_cast<const int4*>(w1p), static_cast<const float*>(w1s),
      static_cast<const float*>(w1b), static_cast<const int4*>(w3p),
      static_cast<const float*>(w3s), static_cast<const float*>(w3b),
      static_cast<const float*>(sx), static_cast<int8_t*>(out), H, W, int(tiles), slope);
  return int(cudaGetLastError());
}
