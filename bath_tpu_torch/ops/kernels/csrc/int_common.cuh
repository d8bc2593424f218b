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
// (msv_filter.cu, vit_filter.cu), and so does the SSV capture on MSV's
// plan (ssv_capture.cu).
//
// Segments.  A model past a block's warps (the class row's word 8,
// S > 1) takes a group of W = 16 warps, the only one of its block, that
// walks each row in S segments of 32 W P lanes, in order; between
// segments a thread's P lanes of each state row wait in the block's slot
// of its class's scratch (word 9; plan.cuh seg_take), segment s, row v,
// lane j of thread t at ((s * NV + v) * P + j) * 32 W + t.  What a segment
// takes from the one before it: the last lane's values
// (lane_before_seg, through a carry in shared memory) and the D chain's
// carry (group_scan_seg); what needs the whole row (its maxima) comes
// after the last segment.

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

// lane_before for a segmented group (W > 1) at segment <s>: thread 0
// takes the previous segment's last lane, which that segment's last
// thread left in <cx> after the exchange, and <fill> in segment 0.
__device__ __forceinline__ void lane_before_seg(const Group& g, int a, int b,
                                                int c, int fill, int s,
                                                int* cx, int& pa, int& pb,
                                                int& pc) {
  pa = __shfl_up_sync(FULL, a, 1);
  pb = __shfl_up_sync(FULL, b, 1);
  pc = __shfl_up_sync(FULL, c, 1);
  if (g.lane == 31) {
    g.x[3 * g.warp] = a;
    g.x[3 * g.warp + 1] = b;
    g.x[3 * g.warp + 2] = c;
  }
  group_sync(g);
  if (g.lane == 0) {
    if (g.warp > 0) {
      pa = g.x[3 * (g.warp - 1)];
      pb = g.x[3 * (g.warp - 1) + 1];
      pc = g.x[3 * (g.warp - 1) + 2];
    } else if (s == 0) {
      pa = pb = pc = fill;
    } else {
      pa = cx[0];
      pb = cx[1];
      pc = cx[2];
    }
  }
  group_sync(g);
  if (g.t == 32 * g.W - 1) {
    cx[0] = a;
    cx[1] = b;
    cx[2] = c;
  }
}

__device__ __forceinline__ int lane_before_seg(const Group& g, int a,
                                               int fill, int s, int* cx) {
  int pa, pb, pc;
  lane_before_seg(g, a, 0, 0, fill, s, cx, pa, pb, pc);
  return pa;
}

// Whether <pred> holds on any thread of the group: a warp vote, or for
// W > 1 a reduction on the group's barrier.
__device__ __forceinline__ bool group_any(const Group& g, bool pred) {
  if (g.W == 1) return __any_sync(FULL, pred);
  unsigned r;
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t"
      "setp.ne.u32 p, %1, 0;\n\t"
      "bar.red.or.pred q, %2, %3, p;\n\t"
      "selp.u32 %0, 1, 0, q;\n\t}"
      : "=r"(r)
      : "r"((unsigned)pred), "r"(g.bar), "r"(32 * g.W)
      : "memory");
  return r != 0;
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

// group_scan_excl for a segmented group (W > 1): also the composition
// of the whole group's maps, the same on every thread.
__device__ __forceinline__ MaxPlus group_scan_seg(const Group& g, MaxPlus x,
                                                  MaxPlus& total) {
  MaxPlus inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    MaxPlus o{__shfl_up_sync(FULL, inc.a, d), __shfl_up_sync(FULL, inc.b, d)};
    if (g.lane >= d) inc = mp_then(o, inc);
  }
  MaxPlus ex{__shfl_up_sync(FULL, inc.a, 1), __shfl_up_sync(FULL, inc.b, 1)};
  if (g.lane == 0) ex = MaxPlus{0, NEG};
  if (g.lane == 31) {
    g.x[2 * g.warp] = inc.a;
    g.x[2 * g.warp + 1] = inc.b;
  }
  group_sync(g);
  MaxPlus pre{0, NEG}, tot{0, NEG};
  for (int w = 0; w < g.W; ++w) {
    const MaxPlus v{g.x[2 * w], g.x[2 * w + 1]};
    if (w < g.warp) pre = mp_then(pre, v);
    tot = mp_then(tot, v);
  }
  group_sync(g);
  total = tot;
  return mp_then(pre, ex);
}

// The map applied to y
__device__ __forceinline__ int mp_apply(const MaxPlus& m, int y) {
  return max(m.b, sat16(y + m.a));
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
