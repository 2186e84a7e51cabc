// K3 — fused confidence threshold + top-k + greedy NMS, per image.
//
// Replaces the TPU kernel mit_driverless_cv_traininginfra_tpu/ops/
// pallas_kernels.py:_pallas_nms_topk (body _nms_topk_kernel), and holds
// the slot layout of its XLA twin _xla_nms_topk (the path's default there):
// slot j is the j-th candidate in lax.top_k order — score descending (+0
// above −0), ties to the lower index, and below-conf slots (score -inf)
// filled with the lowest indices not yet chosen — suppressed slots keep
// their place with keep = false.
//
// On the card: a thread-block cluster of kCtas (8) CTAs per image, each
// CTA over its own chunk of ceil(N / 8) scores. A thread reads its 8
// scores once, coalesced, into registers as unique 64-bit keys
// order_key(masked) << 32 | (0xffffffff − index): larger is better, and a
// real key is ≥ 0x007fffff << 32 even at -inf, so key 0 pads below all of
// them. The 8 are sorted in registers (a 19-comparator network); each
// warp then takes its top k, descending, by k rounds of a warp max of the
// lanes' first keys (__reduce_max_sync on the high words, and on the low
// words only where lanes tie on the high one), the winning lane writing
// its key and shifting the next one up. The CTA merges the warps' runs in
// shared memory, pairwise by a warp's bitonic merge (k ≤ 16; above, by
// ranking every key). Each CTA pushes its top k into the leader's shared
// memory over DSMEM and meets the cluster barrier once; the leader merges
// the 8 runs the same way — exact, since the top k of a union of unique
// keys is the top k of the parts' top k. The leader gathers
// the k boxes, computes one IoU pair per lane (no +1, union == 0 → 1,
// NaN-propagating min/max, built without FMA contraction, so it rounds
// exactly as ops/boxes.py:iou_no_plus_one_pairwise), turns each row's
// `iou > overlap` into a bit mask by __ballot_sync, and runs the greedy
// suppression as k steps of 64-bit operations. No scratch leaves the SMs.
// Bound: latency — the bytes (N·4 scores and k boxes per image) take under
// a microsecond at 3.35 TB/s; what is left is a chain of k dependent warp
// rounds, two merges, one cluster barrier and the leader's tail. A chunk
// larger than a CTA's registers hold (1024 threads × 8 keys) is taken in
// tiles, each merged into the CTA's running top k.
#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace mdcv {

using u64 = unsigned long long;

constexpr int kMaxK = 64;
constexpr int kCtas = 8;  // CTAs per image: the largest portable cluster
constexpr int kKeysPerThread = 8;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / kWarp;

// f32 → uint32 in lax.top_k's order: monotone, +0 above −0
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // -inf → 0x007fffff
}

__device__ __forceinline__ int key_index(u64 key) {
  return int(0xffffffffu - uint32_t(key & 0xffffffffull));
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }  // keeps NaN

__device__ __forceinline__ u64 max_u64(u64 a, u64 b) { return a > b ? a : b; }
__device__ __forceinline__ u64 min_u64(u64 a, u64 b) { return a > b ? b : a; }

// p, q ← max, min
__device__ __forceinline__ void exchange(u64& p, u64& q) {
  const u64 a = p;
  p = max_u64(a, q);
  q = min_u64(a, q);
}

// A lane's keys sorted descending in registers: Batcher's 19-comparator
// network for 8
static_assert(kKeysPerThread == 8, "sort8 sorts 8 keys");
__device__ __forceinline__ void sort8(u64 (&k)[kKeysPerThread]) {
  exchange(k[0], k[1]), exchange(k[2], k[3]), exchange(k[4], k[5]), exchange(k[6], k[7]);
  exchange(k[0], k[2]), exchange(k[1], k[3]), exchange(k[4], k[6]), exchange(k[5], k[7]);
  exchange(k[1], k[2]), exchange(k[5], k[6]);
  exchange(k[0], k[4]), exchange(k[1], k[5]), exchange(k[2], k[6]), exchange(k[3], k[7]);
  exchange(k[2], k[4]), exchange(k[3], k[5]);
  exchange(k[1], k[2]), exchange(k[3], k[4]), exchange(k[5], k[6]);
}

// The k largest of the n keys of `cand` into out[0, k) (which the caller
// zeroed), descending: a real key's slot is the number of keys above it,
// unique since no real key repeats. Pad keys (0) are not placed: the slots
// they would take stay 0.
__device__ void select_top(const u64* cand, int n, int k, u64* out) {
  for (int a = threadIdx.x; a < n; a += blockDim.x) {
    const u64 v = cand[a];
    if (v == 0ull) continue;
    int rank = 0;
#pragma unroll 8
    for (int b = 0; b < n; ++b) rank += cand[b] > v;
    if (rank < k) out[rank] = v;
  }
}

// One warp: the top k (≤ 16) of the descending runs a and b into a. a,
// then b reversed, is a bitonic sequence of 32 (pads of 0 included); five
// compare-exchange stages over the lanes sort it descending.
__device__ __forceinline__ void warp_merge(u64* a, const u64* b, int k, int lane) {
  constexpr int H = kWarp / 2;
  u64 x = lane < H ? (lane < k ? a[lane] : 0ull) : (kWarp - 1 - lane < k ? b[kWarp - 1 - lane] : 0ull);
#pragma unroll
  for (int s = H; s > 0; s >>= 1) {
    const u64 y = __shfl_xor_sync(0xffffffffu, x, s);
    x = (lane & s) ? min_u64(x, y) : max_u64(x, y);
  }
  __syncwarp();  // every lane has read a and b
  if (lane < k) a[lane] = x;
}

// The top k of `runs` descending runs of k keys (run r at cand + r·k; no
// real key in two runs, pads of 0) into out[0, k), descending. For k ≤ 16
// the runs are merged pairwise, a warp a pair, in ceil(log2 runs) rounds;
// above, every key is ranked by select_top. Ends on a block barrier.
__device__ void merge_runs(u64* cand, int runs, int k, u64* out) {
  if (k > kWarp / 2) {
    for (int t = threadIdx.x; t < k; t += blockDim.x) out[t] = 0ull;
    __syncthreads();
    select_top(cand, runs * k, k, out);
    __syncthreads();
    return;
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  for (int width = 1; width < runs; width *= 2) {
    for (int ra = 2 * width * warp; ra + width < runs; ra += 2 * width * nwarps)
      warp_merge(cand + ra * k, cand + (ra + width) * k, k, lane);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < k; t += blockDim.x) out[t] = cand[t];
  __syncthreads();
}

// Whether slot j's box overlaps slot i's beyond `overlap`: the IoU with no
// +1, a zero union divided by 1, NaN-propagating min/max, in the order of
// ops/boxes.py:iou_no_plus_one_pairwise (a NaN IoU overlaps nothing)
__device__ __forceinline__ bool overlaps(const float (*cand)[4], int i, int j, float overlap) {
  const float area_i = (cand[i][2] - cand[i][0]) * (cand[i][3] - cand[i][1]);
  const float x1 = max_nan(cand[i][0], cand[j][0]);
  const float y1 = max_nan(cand[i][1], cand[j][1]);
  const float x2 = min_nan(cand[i][2], cand[j][2]);
  const float y2 = min_nan(cand[i][3], cand[j][3]);
  const float inter = clamp0(x2 - x1) * clamp0(y2 - y1);
  const float area_j = (cand[j][2] - cand[j][0]) * (cand[j][3] - cand[j][1]);
  const float uni = area_i + area_j - inter;
  return inter / (uni == 0.f ? 1.f : uni) > overlap;
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kMaxThreads)
    nms_topk_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                    float* __restrict__ out_boxes, float* __restrict__ out_scores,
                    int32_t* __restrict__ out_idx, bool* __restrict__ out_keep, int N, int k,
                    float conf, float overlap) {
  // top: the CTA's running top k. pool: one k-run per warp and a copy of
  // top after them. gathered: in the leader, every CTA's top k, pushed
  // there over DSMEM
  __shared__ u64 pool[(kMaxWarps + 1) * kMaxK];
  __shared__ u64 top[kMaxK];
  __shared__ u64 gathered[kCtas * kMaxK];
  __shared__ float cand[kMaxK][4];
  __shared__ float top_val[kMaxK];
  __shared__ uint32_t hits[kMaxK][2];  // row i: bit j set where slot j overlaps slot i, j > i
  __shared__ u64 keep_bits;

  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const size_t b = blockIdx.x / kCtas;
  const int c = blockIdx.x % kCtas;
  const float* sc = scores + b * N;
  const int chunk = (N + kCtas - 1) / kCtas;
  const int lo = min(N, c * chunk), hi = min(N, lo + chunk);
  const int tile = blockDim.x * kKeysPerThread;
  // a CTA may write to another's shared memory once all have started:
  // arrive now, wait (at once, by then) before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  for (int t = tid; t < k; t += blockDim.x) top[t] = 0ull;
  __syncthreads();
  for (int base = lo; base < hi; base += tile) {
    u64 key[kKeysPerThread];
#pragma unroll
    for (int r = 0; r < kKeysPerThread; ++r) {
      const int i = base + r * blockDim.x + tid;
      key[r] = 0ull;
      if (i < hi) {
        const float s = sc[i];
        key[r] = (u64(order_key(s > conf ? s : -INFINITY)) << 32) | (0xffffffffu - uint32_t(i));
      }
    }
    sort8(key);  // the lane's keys, best first: a drop is a shift
    // the warp's top k, descending: k rounds of a warp max of the lanes'
    // first keys — of the high words, then (where lanes tie on it) of the
    // low words; the lane holding it writes it and shifts the next one up
    u64* run = pool + warp * k;
    for (int j = 0; j < k; ++j) {
      const u64 best = key[0];
      const uint32_t my_hi = uint32_t(best >> 32);
      const uint32_t hi_word = __reduce_max_sync(0xffffffffu, my_hi);
      if (hi_word == 0u) {  // only pads are left
        for (int jj = j + lane; jj < k; jj += kWarp) run[jj] = 0ull;
        break;
      }
      bool mine = my_hi == hi_word;
      const uint32_t tied = __ballot_sync(0xffffffffu, mine);
      if (tied & (tied - 1u)) {
        const uint32_t lo_word = __reduce_max_sync(0xffffffffu, mine ? uint32_t(best) : 0u);
        mine = mine && uint32_t(best) == lo_word;
      }
      if (mine) {  // keys are unique: one lane holds it
        run[j] = best;
#pragma unroll
        for (int r = 0; r + 1 < kKeysPerThread; ++r) key[r] = key[r + 1];
        key[kKeysPerThread - 1] = 0ull;
      }
    }
    // the warps' runs and, after them, the running top k: one merge
    for (int t = tid; t < k; t += blockDim.x) pool[nwarps * k + t] = top[t];
    __syncthreads();
    merge_runs(pool, nwarps + 1, k, top);
  }

  cg::cluster_group cluster = cg::this_cluster();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  u64* dst = cluster.map_shared_rank(gathered, 0);
  for (int t = tid; t < k; t += blockDim.x) dst[c * k + t] = top[t];
  cluster.sync();  // the leader holds every CTA's top k: the others leave
  if (c != 0) return;
  merge_runs(gathered, kCtas, k, top);

  // the leader: gather, IoU bit masks, greedy suppression
  const float* bx = boxes + b * N * 4;
  for (int t = tid; t < k; t += blockDim.x) {
    const int i = key_index(top[t]);
    const float s = sc[i];
    const float v = s > conf ? s : -INFINITY;
    top_val[t] = v;
    out_scores[b * k + t] = v;
    out_idx[b * k + t] = i;
    for (int q = 0; q < 4; ++q) {
      cand[t][q] = bx[(size_t)i * 4 + q];
      out_boxes[(b * k + t) * 4 + q] = cand[t][q];
    }
  }
  __syncthreads();
  const int words = (k + kWarp - 1) / kWarp;
  if (k <= kWarp / 2) {  // two rows of 16 slots a warp
    for (int task = warp; 2 * task < k; task += nwarps) {
      const int i = 2 * task + lane / (kWarp / 2), j = lane % (kWarp / 2);
      const uint32_t bits = __ballot_sync(0xffffffffu, i < k && j > i && j < k &&
                                                           overlaps(cand, i, j, overlap));
      if (lane == 0) {
        hits[2 * task][0] = bits & 0xffffu;
        if (2 * task + 1 < k) hits[2 * task + 1][0] = bits >> 16;
      }
    }
  } else {  // a row's `words` words of 32 slots a warp each
    for (int task = warp; task < k * words; task += nwarps) {
      const int i = task / words, j = (task % words) * kWarp + lane;
      const uint32_t bits = __ballot_sync(0xffffffffu, j > i && j < k && overlaps(cand, i, j, overlap));
      if (lane == 0) hits[i][task % words] = bits;
    }
  }
  __syncthreads();
  if (tid == 0) {
    u64 alive = 0ull;
#pragma unroll 8
    for (int t = 0; t < k; ++t) alive |= u64(isfinite(top_val[t])) << t;
#pragma unroll 8
    for (int i = 0; i < k; ++i) {  // a kept slot suppresses the later ones it overlaps
      const u64 row = u64(hits[i][0]) | (words > 1 ? u64(hits[i][1]) << 32 : 0ull);
      if ((alive >> i) & 1ull) alive &= ~row;
    }
    keep_bits = alive;
  }
  __syncthreads();
  for (int t = tid; t < k; t += blockDim.x) out_keep[b * k + t] = (keep_bits >> t) & 1ull;
}

}  // namespace mdcv

extern "C" int mdcv_nms_topk(const void* boxes, const void* scores, void* out_boxes,
                             void* out_scores, void* out_idx, void* out_keep, int B, int N, int k,
                             float conf, float overlap, void* stream) {
  using namespace mdcv;
  if (k < 1 || k > kMaxK || N < k) return int(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int chunk = (N + kCtas - 1) / kCtas;
  const int want = (chunk + kKeysPerThread - 1) / kKeysPerThread;
  const int threads = std::min(kMaxThreads, std::max(kWarp, (want + kWarp - 1) / kWarp * kWarp));
  nms_topk_kernel<<<unsigned(B) * kCtas, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<float*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<int32_t*>(out_idx), static_cast<bool*>(out_keep), N, k, conf, overlap);
  return int(cudaGetLastError());
}
