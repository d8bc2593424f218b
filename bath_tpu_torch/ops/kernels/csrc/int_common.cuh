// Shared device code of the integer filter kernels (msv_filter.cu,
// ssv_capture.cu, vit_filter.cu).
//
// Layout.  Items are ORFs read straight from one int8 residue stream at
// their own offsets.  One item is computed by a group of W warps; its
// model lanes k = 0..Mp-1 (lane k = model position k+1, lanes >= M are
// padding) are split into contiguous runs of P lanes, one run per
// thread, held in registers (loader.layout picks P and W).  Within a
// warp the lane-neighbour exchange and the row maxima are warp shuffles
// and reductions; W > 1 adds exchanges through a small shared scratch of
// the group's behind a barrier of the group's own (group_sync).
//
// Every maximum over model lanes is masked to the M real lanes: the
// host reference works on exactly M+1 positions.
//
// The tables are int16 words stored warp-transposed (lane_at): a warp's
// 32P lanes as P rows of 32, so that lane j of the warp's 32 threads is
// 32 neighbouring halfwords, free of bank conflicts.  MSV and the
// ViterbiFilter plan their one launch for every width with plan.cuh
// (msv_filter.cu, vit_filter.cu); the SSV capture puts eight one-warp
// items in a block, or one item of W > 1 warps (its group is the block,
// barrier 0), and its blocks stride over the items (bi_plan).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bi {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -32768;

struct Group {
  int W;     // warps per item
  int warp;  // this warp's index in the group
  int lane;
  int t;     // thread index in the group
  int bar;   // the group's named barrier (W > 1); 0 when it is the block
  int* x;    // shared scratch of 4*W ints (W > 1)
};

// A group that is the whole block (W > 1) or one warp of it.
__device__ __forceinline__ Group make_group(int W, int* scratch) {
  Group g;
  g.W = W;
  g.warp = (threadIdx.x >> 5) % W;
  g.lane = threadIdx.x & 31;
  g.t = g.warp * 32 + g.lane;
  g.bar = 0;
  g.x = scratch;
  return g;
}

// Barrier of the W warps of a group (W > 1); other groups of the block
// do not take part.
__device__ __forceinline__ void group_sync(const Group& g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(32 * g.W) : "memory");
}

__device__ __forceinline__ int sat16(int v) { return min(max(v, NEG), 32767); }

__device__ __forceinline__ int group_max(const Group& g, int v) {
  v = __reduce_max_sync(FULL, v);
  if (g.W == 1) return v;
  if (g.lane == 0) g.x[g.warp] = v;
  group_sync(g);
  int r = g.x[0];
  for (int w = 1; w < g.W; ++w) r = max(r, g.x[w]);
  group_sync(g);
  return r;
}

__device__ __forceinline__ int group_min(const Group& g, int v) {
  v = __reduce_min_sync(FULL, v);
  if (g.W == 1) return v;
  if (g.lane == 0) g.x[g.warp] = v;
  group_sync(g);
  int r = g.x[0];
  for (int w = 1; w < g.W; ++w) r = min(r, g.x[w]);
  group_sync(g);
  return r;
}

// The values a, b, c of lane k0-1 (the previous thread's last lane, or
// the previous warp's for W > 1); <fill> at lane -1.
__device__ __forceinline__ void lane_before(const Group& g, int a, int b, int c,
                                            int fill, int& pa, int& pb,
                                            int& pc) {
  pa = __shfl_up_sync(FULL, a, 1);
  pb = __shfl_up_sync(FULL, b, 1);
  pc = __shfl_up_sync(FULL, c, 1);
  if (g.W > 1) {
    if (g.lane == 31) {
      g.x[3 * g.warp] = a;
      g.x[3 * g.warp + 1] = b;
      g.x[3 * g.warp + 2] = c;
    }
    group_sync(g);
    if (g.lane == 0 && g.warp > 0) {
      pa = g.x[3 * (g.warp - 1)];
      pb = g.x[3 * (g.warp - 1) + 1];
      pc = g.x[3 * (g.warp - 1) + 2];
    }
    group_sync(g);
  }
  if (g.t == 0) pa = pb = pc = fill;
}

__device__ __forceinline__ int lane_before(const Group& g, int a, int fill) {
  int pa, pb, pc;
  lane_before(g, a, 0, 0, fill, pa, pb, pc);
  return pa;
}

// A (max, +) map of the D->D chain: y -> max(b, sat16(y + a)).  With
// every a <= 0, saturation only clamps from below, and maps compose
// exactly when a is summed unsaturated (clamped at A_FLOOR, far below
// where a clamp could matter: y + a <= -32768 either way).
constexpr int A_FLOOR = -(1 << 20);

struct MaxPlus {
  int a, b;
};

// the map that applies `first`, then `second`
__device__ __forceinline__ MaxPlus mp_then(const MaxPlus& first,
                                           const MaxPlus& second) {
  return MaxPlus{max(first.a + second.a, A_FLOOR),
                 max(second.b, sat16(first.b + second.a))};
}

// The composition of the maps of all threads before this one, in lane
// order (identity (0, NEG) at thread 0).
__device__ __forceinline__ MaxPlus group_scan_excl(const Group& g, MaxPlus x) {
  MaxPlus inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    MaxPlus o{__shfl_up_sync(FULL, inc.a, d), __shfl_up_sync(FULL, inc.b, d)};
    if (g.lane >= d) inc = mp_then(o, inc);
  }
  MaxPlus ex{__shfl_up_sync(FULL, inc.a, 1), __shfl_up_sync(FULL, inc.b, 1)};
  if (g.lane == 0) ex = MaxPlus{0, NEG};
  if (g.W == 1) return ex;
  if (g.lane == 31) {
    g.x[2 * g.warp] = inc.a;
    g.x[2 * g.warp + 1] = inc.b;
  }
  group_sync(g);
  MaxPlus pre{0, NEG};
  for (int w = 0; w < g.warp; ++w) pre = mp_then(pre, MaxPlus{g.x[2 * w], g.x[2 * w + 1]});
  group_sync(g);
  return mp_then(pre, ex);
}

// The table position x of a row holds lane lane_at(x, P): a warp's 32P
// lanes stored as P rows of 32, so that thread t's lane j lies at
// 32j + t (ops/multimodel.py warp_lanes).
__device__ __forceinline__ int lane_at(int x, int P) {
  const int span = 32 * P;
  const int w = x / span, r = x - w * span;
  return w * span + (r & 31) * P + (r >> 5);
}

// Copies <bytes> (a multiple of 16) from <src> into shared memory at
// <dst> in 16-byte words; every thread of the block calls it, then the
// block syncs.
__device__ __forceinline__ void stage_words(const void* __restrict__ src,
                                            size_t bytes, void* dst) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  for (size_t q = threadIdx.x; q < bytes / 16; q += blockDim.x) d[q] = s[q];
  __syncthreads();
}

}  // namespace bi

// Host side: the block shape, shared memory and grid of a launch.
struct BiLaunch {
  int W, G, threads, blocks;
  bool in_smem;
  size_t smem;
};

// The SSV capture's launch: tables of `tab_bytes` go to shared memory
// when they fit in 100 KB; the rest of the block's shared memory is the
// W > 1 scratch.  The grid is as many blocks as the card holds at once,
// at most one item per warp.
template <typename K>
static inline BiLaunch bi_plan(K kernel, int B, int Mp, int P,
                               size_t tab_bytes) {
  BiLaunch l;
  l.W = Mp / (32 * P);
  l.G = l.W == 1 ? 8 : 1;
  l.threads = 32 * l.W * l.G;
  l.in_smem = tab_bytes <= 100 * 1024;
  l.smem = (l.in_smem ? tab_bytes : 0) + 4 * sizeof(int) * l.W;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)l.smem);
  int dev = 0, sms = 1, per = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, l.threads,
                                                l.smem);
  const int need = (B + l.G - 1) / l.G;
  l.blocks = need < sms * (per > 0 ? per : 1) ? need : sms * (per > 0 ? per : 1);
  return l;
}

#define BI_DISPATCH_P(P, CALL)        \
  switch (P) {                        \
    case 3: CALL(3); break;           \
    case 5: CALL(5); break;           \
    case 9: CALL(9); break;           \
    case 13: CALL(13); break;         \
    case 17: CALL(17); break;         \
    case 25: CALL(25); break;         \
    case 33: CALL(33); break;         \
    default: return cudaErrorInvalidValue; \
  }
