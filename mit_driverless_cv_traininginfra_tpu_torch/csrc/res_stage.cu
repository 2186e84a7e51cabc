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
// plain version, which this kernel equals bit for bit: int32 sums (exact
// in any order: 2304·127² < 2³¹); acc·scale then +b as two f32 roundings
// (-fmad=false, __fmul_rn / __fadd_rn); a bf16 cast; leaky comparing the
// f32 value and multiplying the bf16 one by the slope rounded to bf16;
// requant = clamp(rintf(x·sx_inv), ±127); the shortcut add in bf16 on a
// bf16 carrier that never goes through int8. The carrier is ybf itself:
// block 0 reads x and writes ybf, later blocks update ybf in place. The
// int8 t lives in device memory between the two kernels, in a
// zero-bordered (S+2)² layout, so the 3×3 reads its zero padding from the
// borders; the first 1×1 writes the zero borders of t, ybf and yq, so a
// call is 2n kernel launches and nothing else (16 at n = 8).
//
// Bound: operations — 113 G int8 operations at 26², C=512, n=8, B=8
// (0.057 ms at 1,979 TOP/s) against 22 MB of bytes (0.0066 ms). Both
// convolutions are implicit GEMMs on the int8 tensor cores, A by ldmatrix
// from XOR-swizzled shared memory (64-byte rows, 16-byte chunk ^= (row >>
// 1) & 3), K in 64-byte chunks through a cp.async ring with one barrier a
// chunk, the weights laid out once on the host by
// ops/resstage.py:pack_res_stage:
//
//   1×1  M = B·S², K = C, N = C/2; mma.sync.m16n8k32 s8, B as fragments
//        (ops/entry.py:_pack_frag), one 16-byte load a lane per two
//        n-tiles. A block of 256 threads takes 48 positions and every
//        output channel: it copies its positions' carrier rows in one batch
//        and quantizes them once (all C channels, int8 in shared memory),
//        then runs N in passes of 256 columns, 32 a warp, the weights'
//        chunks through a 4-stage ring (at B=8: 113 blocks).
//   3×3  M = B·S², K = 9·(C/2) taps-major (zero-padded to 64 bytes), N = C;
//        wgmma.m64n128k32 s8, B as K-major core-matrix tiles
//        (ops/entry.py:_pack_wgmma) read by descriptor. A block of 3
//        warpgroups takes 192 positions × 128 channels, a warpgroup 64 rows;
//        A rows are gathered by cp.async from the zero-bordered t at each
//        tap's offset (a table of each chunk's offsets, made once a block),
//        with B, through a 4-stage ring of 20 KB stages (at B=8: 29 × 4 =
//        116 blocks, one wave on 132 SMs; at B=128, 14 waves). The block's
//        carrier tile is copied into shared memory at its start, under the
//        main loop.
//
// What this design answers (clock64 phases of patched copies of a first,
// mma.sync design on an H100): most of the 3×3's main loop went to issuing
// its copies (runtime divisions, generic loops), not to its products, and
// its epilogue waited on each carrier load in turn; the 1×1 waited on its A
// loads one by one; conversion instructions (rintf, float→int) run at a
// quarter of the ALU rate, which q8_bits avoids. A 3×3 over bands of whole
// rows, copying each band's window of t once and reading the taps at
// offsets (9× fewer A bytes), was slower: 7-row bands of a 26² map fill
// 88% of a block's 192 rows.
//
// Epilogues: a quad transpose (quad_transpose) gives a lane eight
// consecutive channels, so the carrier is read and written 16 bytes at a
// time, yq and t 8 bytes at a time.
#include <atomic>

#include "int8_mma.cuh"

namespace mdcv {
namespace rs {

constexpr int kChunk = 64;                          // bytes of K a pipeline stage
constexpr int kMaxC = 1024;
// 1×1: mma.sync, 8 warps
constexpr int kThreads1 = 256, kWarps1 = kThreads1 / kWarp;
constexpr int kBM1 = 48, kMT1 = kBM1 / 16;          // positions a block, its m-tiles
constexpr int kNB1 = kWarps1 * 32;                  // columns a pass, 32 a warp
constexpr int kStages1 = 4;
constexpr int kBStage1 = kNB1 * kChunk;             // 16 KB
// shared memory: int8 A (48 × C), its bf16 rows as loaded (48 × 2C), B ring
__host__ __device__ constexpr int smem1(int C) { return 3 * kBM1 * C + kStages1 * kBStage1; }
// 3×3: wgmma, 3 warpgroups of m64 × n128
constexpr int kWG3 = 3, kThreads3 = kWG3 * 128;
constexpr int kBM3 = 64 * kWG3, kBN3 = 128;         // a block's tile
constexpr int kStages3 = 4;
constexpr int kAStage3 = kBM3 * kChunk;             // 12 KB
constexpr int kBStage3 = kBN3 * kChunk;             // 8 KB: 2 k-steps × 4 wgmma B tiles
constexpr int kMaxKC3 = (9 * kMaxC / 2 + kChunk - 1) / kChunk;
constexpr int kOffB3 = kStages3 * kAStage3;
constexpr int kOffRes3 = kOffB3 + kStages3 * kBStage3;  // the carrier tile, bf16
constexpr int kOffTab3 = kOffRes3 + kBM3 * kBN3 * 2;     // t offset of each (chunk, piece)
constexpr int kOffPar3 = kOffTab3 + kMaxKC3 * 4 * 4;      // scales, biases
constexpr int kSmem3 = kOffPar3 + 2 * kBN3 * 4;
static_assert(smem1(kMaxC) <= 232448 && kSmem3 <= 232448, "shared memory");
static_assert(kBM3 * kChunk / 16 == 2 * kThreads3, "two A pieces a thread a stage");
static_assert(kBStage3 / 16 <= 2 * kThreads3, "at most two B pieces a thread a stage");

// zero-bordered flat index of interior position m = (img, y, x) of an S×S map
__device__ __forceinline__ size_t padded_pos(int m, int S) {
  const int img = m / (S * S), r = m % (S * S);
  return (size_t(img) * (S + 2) + r / S + 1) * (S + 2) + r % S + 1;
}

// byte offset of 16-byte chunk c of row r in a stage of 64-byte rows
__device__ __forceinline__ int a_off(int r, int c) { return r * kChunk + ((c ^ ((r >> 1) & 3)) << 4); }

// zeros on the border positions of t, ybf and yq (the kernels write only
// interiors), spread over the grid
__device__ void zero_borders(int8_t* tq, __nv_bfloat16* ybf, int8_t* yq, int B, int S, int C,
                             int Cm) {
  const int W = S + 2, per = 4 * S + 4;  // border positions an image
  const int u_bf = 2 * C / 16, u_q = C / 16, units = u_bf + u_q + Cm / 16;
  const long long total = (long long)B * per * units;
  const int4 z = make_int4(0, 0, 0, 0);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int u = int(i % units), j = int((i / units) % per), img = int(i / units / per);
    int y, x;
    if (j < W) {
      y = 0, x = j;
    } else if (j < 2 * W) {
      y = S + 1, x = j - W;
    } else {
      y = 1 + (j - 2 * W) / 2, x = ((j - 2 * W) & 1) ? S + 1 : 0;
    }
    const size_t pos = (size_t(img) * W + y) * W + x;
    if (u < u_bf)
      reinterpret_cast<int4*>(ybf + pos * C)[u] = z;
    else if (u < u_bf + u_q)
      reinterpret_cast<int4*>(yq + pos * C)[u - u_bf] = z;
    else
      reinterpret_cast<int4*>(tq + pos * Cm)[u - u_bf - u_q] = z;
  }
}

// 1×1 C→Cm on the bf16 carrier `src`, quantized on load with sx1; writes
// tq = q8(leaky(deq(acc)), sx3) at the interior of the zero-bordered t.
// w: (C/32, Cm/32, 2, 32, 16) mma.sync B fragments.
__global__ void __launch_bounds__(kThreads1)
    conv1x1_kernel(const __nv_bfloat16* src, const int4* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const float* __restrict__ sx1, const float* __restrict__ sx3,
                   int8_t* tq, __nv_bfloat16* ybf, int8_t* yq, int M, int S, int C, int Cm,
                   float slope, int zero) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sA = smem;                      // [C/64][48 rows][64 bytes]
  unsigned char* raw = smem + kBM1 * C;          // [48 rows][C] bf16, as loaded
  unsigned char* sB = raw + 2 * kBM1 * C;        // kStages1 × [k-step 2][group 8][2][32][16]
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int m0 = blockIdx.x * kBM1, KC = C / kChunk, per_row = C / 8;
  if (zero) zero_borders(tq, ybf, yq, M / (S * S), S, C, Cm);

  // A: the block's positions' carrier rows, every channel, in one batch of
  // copies (zeros past M), then quantized once
  for (int i = tid; i < kBM1 * per_row; i += kThreads1) {
    const int r = i / per_row, m = m0 + r;
    const __nv_bfloat16* s = m < M ? src + padded_pos(m, S) * C + (i - r * per_row) * 8 : src;
    cp_async16(raw + size_t(i) * 16, s, m < M ? 16 : 0);
  }
  cp_async_commit();

  const float s_in = *sx1, s_out = *sx3;
  for (int nb0 = 0; nb0 < Cm; nb0 += kNB1) {
    // the pass's B pieces this thread copies, as offsets (16-byte units) from
    // the chunk's first k-step in w and into the stage
    const int groups = min(kNB1, Cm - nb0) / 32, pieces = 2 * groups * 64;
    int b_src[4], b_dst[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = tid + e * kThreads1, ks = p / (groups * 64), rem = p - ks * groups * 64;
      b_src[e] = ks * (Cm / 32) * 64 + (nb0 / 32) * 64 + rem;
      b_dst[e] = ks * (kNB1 / 32) * 64 + rem;
    }
    auto load_b = [&](int slot, int kc) {
      const int4* wk = w + size_t(2 * kc) * (Cm / 32) * 64;
      unsigned char* dst = sB + slot * kBStage1;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (tid + e * kThreads1 < pieces) cp_async16(dst + b_dst[e] * 16, wk + b_src[e], 16);
    };
#pragma unroll
    for (int s = 0; s < kStages1 - 1; ++s) {
      if (s < KC) load_b(s, s);
      cp_async_commit();
    }
    if (nb0 == 0) {
      cp_async_wait<kStages1 - 1>();  // the raw rows (the oldest group) landed
      __syncthreads();
#pragma unroll 4
      for (int i = tid; i < kBM1 * per_row; i += kThreads1) {
        const uint4 v = reinterpret_cast<const uint4*>(raw)[i];
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) q[e] = q8_bits(__bfloat162float(h[e]), s_in);
        const int r = i / per_row, c = (i - r * per_row) * 8;
        *reinterpret_cast<uint2*>(sA + (c / kChunk) * (kBM1 * kChunk) +
                                  a_off(r, (c % kChunk) >> 4) + (c & 15)) =
            make_uint2(pack_q8(q[0], q[1], q[2], q[3]), pack_q8(q[4], q[5], q[6], q[7]));
      }
    }
    int acc[kMT1][4][4] = {};
    for (int kc = 0; kc < KC; ++kc) {
      cp_async_wait<kStages1 - 2>();
      __syncthreads();  // chunk kc landed for all; the slot refilled next is free
      if (kc + kStages1 - 1 < KC) load_b((kc + kStages1 - 1) % kStages1, kc + kStages1 - 1);
      cp_async_commit();
      if (warp < groups) {
        const unsigned char* aS = sA + kc * (kBM1 * kChunk);
        const int4* bS = reinterpret_cast<const int4*>(sB + (kc % kStages1) * kBStage1);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t a[kMT1][4];
#pragma unroll
          for (int mi = 0; mi < kMT1; ++mi)
            ldmatrix_x4(smem_u32(aS + a_off(16 * mi + arow, 2 * ks + ahalf)), a[mi]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int4 b = bS[(ks * (kNB1 / 32) + warp) * 64 + q * kWarp + lane];
#pragma unroll
            for (int mi = 0; mi < kMT1; ++mi) {
              mma_s8(acc[mi][2 * q], a[mi], b.x, b.y);
              mma_s8(acc[mi][2 * q + 1], a[mi], b.z, b.w);
            }
          }
        }
      }
    }
    if (warp < groups) {
      // n-tile nt: columns n0 + 8nt + 2t4, +1 of rows g, g + 8
      const int n0 = nb0 + 32 * warp;
      float2 sc[4], bi[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt] = *reinterpret_cast<const float2*>(scale + n0 + 8 * nt + 2 * t4);
        bi[nt] = *reinterpret_cast<const float2*>(bias + n0 + 8 * nt + 2 * t4);
      }
#pragma unroll
      for (int mi = 0; mi < kMT1; ++mi) {
        uint32_t v[4];  // bytes: row g's two columns, then row g + 8's
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int* c = acc[mi][nt];
          const uint32_t r0 = deq_leaky2(c[0], c[1], sc[nt], bi[nt], slope);
          const uint32_t r1 = deq_leaky2(c[2], c[3], sc[nt], bi[nt], slope);
          v[nt] = pack_q8(q8_bits(__uint_as_float(r0 << 16), s_out),
                          q8_bits(__uint_as_float(r0 & 0xffff0000u), s_out),
                          q8_bits(__uint_as_float(r1 << 16), s_out),
                          q8_bits(__uint_as_float(r1 & 0xffff0000u), s_out));
        }
        quad_transpose(v, t4);  // → n-tile t4, columns 2j, 2j+1 from word j
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int m = m0 + 16 * mi + g + 8 * rr;
          const uint32_t sel = rr ? 0x7632 : 0x5410;
          if (m < M)
            *reinterpret_cast<uint2*>(tq + padded_pos(m, S) * Cm + n0 + 8 * t4) =
                make_uint2(__byte_perm(v[0], v[1], sel), __byte_perm(v[2], v[3], sel));
        }
      }
    }
    __syncthreads();  // the next pass refills the B slots
  }
}

// 3×3 Cm→C on the zero-bordered tq, then the shortcut: ybf ←
// bf16(leaky(deq(acc)) + res) (res is x for block 0, else ybf itself);
// with yq non-null (the last block) also yq = q8(ybf, sx_out).
// w: (Kp/32, C/32, 4, 2, 8, 16) wgmma B tiles, Kp = 9·Cm padded to 64.
__global__ void __launch_bounds__(kThreads3, 1)
    conv3x3_kernel(const int8_t* __restrict__ tq, const int4* __restrict__ w,
                   const float* __restrict__ scale, const float* __restrict__ bias,
                   const __nv_bfloat16* res, __nv_bfloat16* ybf,
                   const float* __restrict__ sx_out, int8_t* __restrict__ yq, int M, int S,
                   int Cm, int C, float slope) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sres = reinterpret_cast<__nv_bfloat16*>(smem + kOffRes3);
  int* tab = reinterpret_cast<int*>(smem + kOffTab3);
  float* par = reinterpret_cast<float*>(smem + kOffPar3);  // scales, then biases
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g = lane >> 2, t4 = lane & 3;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8, ahalf = lane >> 4;
  const int m0 = blockIdx.x * kBM3, n0 = blockIdx.y * kBN3;
  const int W = S + 2, K = 9 * Cm, KC = (K + kChunk - 1) / kChunk;
  const int groups = min(kBN3, C - n0) / 32;  // 32-column B tiles of this block

  // each (chunk, 16-byte piece)'s offset in t from a row's tap (0, 0), −1 past K
  for (int i = tid; i < KC * 4; i += kThreads3) {
    const int k = (i >> 2) * kChunk + (i & 3) * 16, tap = k / Cm;
    tab[i] = k < K ? ((tap / 3) * W + tap % 3) * Cm + (k - tap * Cm) : -1;
  }
  for (int i = tid; i < kBN3; i += kThreads3) {
    const bool in = n0 + i < C;
    par[i] = in ? scale[n0 + i] : 0.f, par[kBN3 + i] = in ? bias[n0 + i] : 0.f;
  }
  // the carrier tile (rows m0.., channels n0..), 16-byte chunk ^= row & 7
  for (int i = tid; i < kBM3 * (kBN3 / 8); i += kThreads3) {
    const int r = i >> 4, ch = i & 15, m = m0 + r;
    const bool in = m < M && n0 + 8 * ch < C;
    cp_async16(sres + r * kBN3 + ((ch ^ (r & 7)) << 3),
               in ? res + padded_pos(m, S) * C + n0 + 8 * ch : res, in ? 16 : 0);
  }
  cp_async_commit();
  // the A pieces this thread copies: 16-byte piece j of rows tid/4 + 96i;
  // abase: the row's tap (0, 0) as an offset in t, or −1 past M
  const int j = tid & 3;
  int abase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 96 * i, img = m / (S * S), r = m % (S * S);
    abase[i] = m < M ? ((img * W + r / S) * W + r % S) * Cm : -1;
  }
  __syncthreads();  // tab
  auto load = [&](int slot, int kc) {
    unsigned char* a = smem + slot * kAStage3;
    const int off = tab[kc * 4 + j];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bool in = off >= 0 && abase[i] >= 0;
      cp_async16(a + a_off((tid >> 2) + 96 * i, j), in ? tq + abase[i] + off : tq, in ? 16 : 0);
    }
    // B: k-steps 2kc, 2kc + 1, each the block's 4 tiles (4 KB) of w
    unsigned char* b = smem + kOffB3 + slot * kBStage3;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = tid + e * kThreads3, ks = p >> 8, rem = p & 255;
      if (p < kBStage3 / 16 && rem < groups * 64)
        cp_async16(b + p * 16, w + (size_t(2 * kc + ks) * (C / 32) + n0 / 32) * 64 + rem, 16);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages3 - 1; ++s) {
    if (s < KC) load(s, s);
    cp_async_commit();
  }
  // warpgroup wg: rows 64wg.. of the tile, this warp 16 of them × 128 columns
  const int row = (warp >> 2) * 64 + (warp & 3) * 16;
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int kc = 0; kc < KC; ++kc) {
    cp_async_wait<kStages3 - 2>();
    fence_proxy_async();  // the copies into the stage, read by wgmma
    __syncthreads();      // chunk kc landed for all; the slot refilled next is free
    if (kc + kStages3 - 1 < KC) load((kc + kStages3 - 1) % kStages3, kc + kStages3 - 1);
    cp_async_commit();
    const int slot = kc % kStages3;
    const unsigned char* aS = smem + slot * kAStage3;
    const unsigned char* bS = smem + kOffB3 + slot * kBStage3;
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      ldmatrix_x4(smem_u32(aS + a_off(row + arow, 2 * ks + ahalf)), a[ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) wgmma_n128(d, a[ks], kmajor_desc(bS + ks * (kBStage3 / 2)));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(a[ks][e]);
#pragma unroll
    for (int i = 0; i < 64; ++i) keep(d[i]);
  }

  // n-tile nt: columns 8nt + 2t4, +1 of rows g, g + 8 of this warp's 16
  const float s_out = yq ? *sx_out : 0.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row + g + 8 * rr, m = m0 + r;
    const size_t pos = m < M ? padded_pos(m, S) : 0;
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) {
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int nt = 4 * grp + jj, n = 8 * nt + 2 * t4;
        v[jj] = deq_leaky2(d[4 * nt + 2 * rr], d[4 * nt + 2 * rr + 1],
                           *reinterpret_cast<const float2*>(par + n),
                           *reinterpret_cast<const float2*>(par + kBN3 + n), slope);
      }
      quad_transpose(v, t4);  // → n-tile 4grp + t4, its 8 columns in order
      const int ch = 4 * grp + t4;
      if (m >= M || n0 + 8 * ch >= C) continue;
      const uint4 cr = *reinterpret_cast<const uint4*>(sres + r * kBN3 + ((ch ^ (r & 7)) << 3));
      const uint32_t cw[4] = {cr.x, cr.y, cr.z, cr.w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // the shortcut add: bf16 + bf16 in f32, one cast
        const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&v[e]);
        const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&cw[e]);
        const __nv_bfloat162 r = __floats2bfloat162_rn(__low2float(y) + __low2float(c),
                                                       __high2float(y) + __high2float(c));
        o[e] = *reinterpret_cast<const uint32_t*>(&r);
      }
      const size_t off = pos * C + n0 + 8 * ch;
      *reinterpret_cast<uint4*>(ybf + off) = make_uint4(o[0], o[1], o[2], o[3]);
      if (yq) {
        uint32_t q[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          q[2 * e] = q8_bits(__uint_as_float(o[e] << 16), s_out);
          q[2 * e + 1] = q8_bits(__uint_as_float(o[e] & 0xffff0000u), s_out);
        }
        *reinterpret_cast<uint2*>(yq + off) =
            make_uint2(pack_q8(q[0], q[1], q[2], q[3]), pack_q8(q[4], q[5], q[6], q[7]));
      }
    }
  }
}

}  // namespace rs
}  // namespace mdcv

// The whole stage: x (B, S+2, S+2, C) bf16 → ybf (the same, the bf16 stage
// output) and yq (B, S+2, S+2, C) int8, both zero-bordered; tq is scratch of
// (B, S+2, S+2, C/2) int8. Weights of block i, as ops/resstage.py:
// pack_res_stage lays them out: w1 + i·C·(C/2) bytes ((C/32, C/64, 2, 32,
// 16) mma.sync fragments), w3 + i·Kp·C bytes ((Kp/32, C/32, 4, 2, 8, 16)
// wgmma tiles, Kp = 9·C/2 padded to 64); scales and biases s1, b1 (n,
// C/2), s3, b3 (n, C); sx1, sx3 (n,), sx_out (1,).
extern "C" int mdcv_res_stage(const void* x, const void* w1, const void* s1, const void* b1,
                              const void* w3, const void* s3, const void* b3, const void* sx1,
                              const void* sx3, const void* sx_out, void* ybf, void* yq,
                              void* tq, int B, int S, int C, int n_blocks, float slope,
                              int dtype, void* stream) {
  using namespace mdcv::rs;
  if (dtype != 1 || S <= 0 || B < 0 || C <= 0 || C % 64 || C > kMaxC || n_blocks <= 0)
    return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const long long M = (long long)B * S * S;
  if ((long long)B * (S + 2) * (S + 2) > 0x7fffffffLL / kMaxC) return int(cudaErrorInvalidValue);
  // the shared-memory opt-ins, once per device
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= kMaxDevices) return int(cudaErrorInvalidDevice);
  if (!ready[dev].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(conv1x1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem1(kMaxC));
    if (e != cudaSuccess) return int(e);
    e = cudaFuncSetAttribute(conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem3);
    if (e != cudaSuccess) return int(e);
    ready[dev].store(true, std::memory_order_release);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int Cm = C / 2, Kp = (9 * Cm + kChunk - 1) / kChunk * kChunk;
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  auto frag = [](const void* p, size_t bytes) {
    return reinterpret_cast<const int4*>(static_cast<const int8_t*>(p) + bytes);
  };
  const auto xb = static_cast<const __nv_bfloat16*>(x);
  const auto yb = static_cast<__nv_bfloat16*>(ybf);
  const unsigned grid1 = unsigned((M + kBM1 - 1) / kBM1);
  const dim3 grid3(unsigned((M + kBM3 - 1) / kBM3), unsigned((C + kBN3 - 1) / kBN3));
  for (int i = 0; i < n_blocks; ++i) {
    conv1x1_kernel<<<grid1, kThreads1, smem1(C), st>>>(
        i == 0 ? xb : yb, frag(w1, size_t(i) * C * Cm), f32(s1) + size_t(i) * Cm,
        f32(b1) + size_t(i) * Cm, f32(sx1) + i, f32(sx3) + i, static_cast<int8_t*>(tq), yb,
        static_cast<int8_t*>(yq), int(M), S, C, Cm, slope, i == 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
    conv3x3_kernel<<<grid3, kThreads3, kSmem3, st>>>(
        static_cast<const int8_t*>(tq), frag(w3, size_t(i) * Kp * C), f32(s3) + size_t(i) * C,
        f32(b3) + size_t(i) * C, i == 0 ? xb : yb, yb, f32(sx_out),
        i == n_blocks - 1 ? static_cast<int8_t*>(yq) : nullptr, int(M), S, Cm, C, slope);
    if ((e = cudaGetLastError()) != cudaSuccess) return int(e);
  }
  return 0;
}
