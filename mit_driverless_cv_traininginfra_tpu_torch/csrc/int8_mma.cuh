// The int8 tensor-core kernels' shared helpers (K4 entry_block.cu, K5
// res_stage.cu, tail_conv.cu): the requant and dequant rounding points of
// the int8 chain, ldmatrix / mma.sync / wgmma wrappers, cp.async, and a
// quad transpose for 16-byte epilogue stores.
#pragma once

#include "common.cuh"

namespace mdcv {

// requant: clamp(rintf(v·sx_inv), ±127), rintf rounding half to even
__device__ __forceinline__ int8_t q8(float v, float sx_inv) {
  const float r = rintf(__fmul_rn(v, sx_inv));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.f), 127.f)));
}

// q8 without conversion instructions (which run at a quarter of the ALU
// rate): clamping before rounding changes nothing (±127 are integers,
// rounding is monotone, and a NaN becomes −127 either way), and adding
// 1.5·2²³ to a value in [−127, 127] rounds it to an integer, half to even,
// whose two's-complement low byte is the low byte of the sum's bits
__device__ __forceinline__ uint32_t q8_bits(float v, float sx_inv) {
  const float c = fminf(fmaxf(__fmul_rn(v, sx_inv), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(c, 12582912.f));
}
// the low bytes of four q8_bits, in order, as one word
__device__ __forceinline__ uint32_t pack_q8(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// int32 → acc·scale + b in f32 (two roundings: __fmul_rn, __fadd_rn) →
// bf16 → leaky (slope already rounded to bf16: the product of two bf16
// values is exact in f32, so it rounds once)
__device__ __forceinline__ __nv_bfloat16 deq_leaky(int acc, float scale, float bias,
                                                   float slope) {
  const float y32 = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  const __nv_bfloat16 y = __float2bfloat16_rn(y32);
  return y32 >= 0.f ? y : __float2bfloat16_rn(__fmul_rn(__bfloat162float(y), slope));
}

// deq_leaky of two columns as a bf16 pair (lo, hi), with packed casts
__device__ __forceinline__ uint32_t deq_leaky2(int a0, int a1, float2 scale, float2 bias,
                                               float slope) {
  const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), scale.x), bias.x);
  const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), scale.y), bias.y);
  const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
  const __nv_bfloat162 n =
      __floats2bfloat162_rn(__fmul_rn(__low2float(y), slope), __fmul_rn(__high2float(y), slope));
  const uint32_t yb = *reinterpret_cast<const uint32_t*>(&y);
  const uint32_t nb = *reinterpret_cast<const uint32_t*>(&n);
  return ((y0 >= 0.f ? yb : nb) & 0xffffu) | ((y1 >= 0.f ? yb : nb) & 0xffff0000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the A fragment of a 16×32 int8 tile: lane l points at row (l & 7) +
// ((l >> 3) & 1)·8, bytes 16·(l >> 4) of it
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// D (16×8 s32) += A (16×32 s8) · B (32×8 s8); not volatile: a pure
// register operation, free to move between loads
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], int b0, int b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// wgmma m64n32k32 s8·s8→s32: D (this warp's 16 rows × 32) += A (this warp's
// 16×32 fragment, registers) · B (32×32, K-major core matrices in shared
// memory, described by desc); accumulate = 0 overwrites D
__device__ __forceinline__ void wgmma_n32(int (&d)[4][4], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]), "+r"(d[1][0]),
        "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]), "+r"(d[2][0]), "+r"(d[2][1]),
        "+r"(d[2][2]), "+r"(d[2][3]), "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]),
        "+r"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
// wgmma m64nNk32 s8·s8→s32, accumulating: D (this warp's 16 rows × N, as
// N/8 mma C fragments: d[4j .. 4j+3] is n-tile j) += A (this warp's 16×32
// fragment, registers) · B (32×N, K-major core matrices in shared memory
// at the uniform strides of kmajor_desc)
__device__ __forceinline__ void wgmma_n64(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps a register's value where the asynchronous wgmma reads or writes it:
// the compiler may neither reuse nor read it across this point
__device__ __forceinline__ void keep(int& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

constexpr int kLBO = 128, kSBO = 256;  // K-adjacent, N-adjacent core matrices
// the shared-memory descriptor of a K-major B tile without swizzle: 8×16-byte
// core matrices, [n-group][k-chunk][8 rows][16 bytes]
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t(kLBO >> 4) << 16) |
         (uint64_t(kSBO >> 4) << 32);
}

// 16 bytes global → shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void cp_async_wait1() { cp_async_wait<1>(); }

// cp.async (and other generic-proxy) writes to shared memory made visible to
// wgmma's operand reads (the async proxy); before the barrier that publishes them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4×4 transpose of 32-bit words over the four lanes of a quad (lanes 4g..
// 4g+3, t = lane & 3): lane t holds v[j] = w(t, j) before and w(j, t)
// after, by two butterfly stages (lanes t ^ 1, then t ^ 2), each trading
// the two words whose index bit differs from the lane's. On an mma C
// fragment, v[j] the pair of columns 2t, 2t+1 of n-tile j, it leaves lane t
// holding n-tile t's eight columns in order. Every lane of the warp must
// take part.
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int t) {
  const bool odd = t & 1, high = t & 2;
  uint32_t x0 = odd ? v[0] : v[1], x1 = odd ? v[2] : v[3];
  x0 = __shfl_xor_sync(0xffffffffu, x0, 1);
  x1 = __shfl_xor_sync(0xffffffffu, x1, 1);
  if (odd) v[0] = x0, v[2] = x1;
  else v[1] = x0, v[3] = x1;
  x0 = high ? v[0] : v[2], x1 = high ? v[1] : v[3];
  x0 = __shfl_xor_sync(0xffffffffu, x0, 2);
  x1 = __shfl_xor_sync(0xffffffffu, x1, 2);
  if (high) v[0] = x0, v[1] = x1;
  else v[2] = x0, v[3] = x1;
}

}  // namespace mdcv
