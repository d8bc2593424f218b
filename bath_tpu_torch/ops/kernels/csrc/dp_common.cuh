// Shared device code of the Forward-gate and domain-decoding kernels.
//
// Layout.  One item (an ORF) is computed by a group of W warps; its
// model lanes k = 0..Mp-1 (lane k = model position k+1) are split into
// contiguous runs of P lanes, one run per thread, held in registers.
// P is odd, so the P-strided shared-memory reads of 32 threads hit 32
// different banks.  W = 1 for M <= 32*33: the group is one warp, the
// lane-neighbour exchange and the D->D scan are warp shuffles, and a
// block holds several independent items.  W > 1 (longer models) adds
// exchanges through shared memory behind the group's own named barrier
// (group_sync), so a block may hold several such groups.
//
// The D->D chain D[k] = tMD[k]*M[k-1] + tDD[k]*D[k-1] is a linear
// recurrence along k: each thread reduces its run to an affine map
// (carry in -> carry out, plus the run's sum of D), the group scans the
// maps, and each thread replays its run from its carry.  This replaces
// the TPU kernels' dense M x M closure operators (W3, UB), which cost
// M^2 multiply-adds per row.
//
// Segments.  A model past a block of 32 warps of 33 lanes (the class
// row's word 8, S > 1) takes a group of W = 16 warps, the only one of
// its block, that walks each row in S segments of 32 W P lanes; between
// segments a thread's P lanes of each state row wait in the block's
// slot of its class's scratch (word 9; plan.cuh seg_take), segment s,
// row v, lane j of thread t at ((s * NV + v) * P + j) * 32 W + t.  A
// segment takes the previous segment's last lane through a carry in
// shared memory (lane_before_seg) and the D chain's carry from
// the scan's total; what needs the whole row (the sums, the rescale)
// comes after the last segment, the rescale applied as the next row
// loads its lanes.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "plan.cuh"

namespace bt {

// transition rows, bath_tpu/constants.py P_* order
enum { P_MM = 0, P_IM, P_DM, P_BM, P_MD, P_DD, P_MI, P_II, NTR };

constexpr unsigned FULL = 0xffffffffu;

// y_out = a * y_in + b; the run's sum of y = c * y_in + e
struct Aff {
  float a, b, c, e;
};

__device__ __forceinline__ Aff aff_identity() { return Aff{1.f, 0.f, 0.f, 0.f}; }

// the map that applies `first`, then `second`
__device__ __forceinline__ Aff aff_then(const Aff& first, const Aff& second) {
  Aff r;
  r.a = second.a * first.a;
  r.b = fmaf(second.a, first.b, second.b);
  r.c = fmaf(second.c, first.a, first.c);
  r.e = first.e + fmaf(second.c, first.b, second.e);
  return r;
}

__device__ __forceinline__ Aff aff_shfl_up(const Aff& x, int d) {
  return Aff{__shfl_up_sync(FULL, x.a, d), __shfl_up_sync(FULL, x.b, d),
             __shfl_up_sync(FULL, x.c, d), __shfl_up_sync(FULL, x.e, d)};
}

__device__ __forceinline__ Aff aff_shfl_down(const Aff& x, int d) {
  return Aff{__shfl_down_sync(FULL, x.a, d), __shfl_down_sync(FULL, x.b, d),
             __shfl_down_sync(FULL, x.c, d), __shfl_down_sync(FULL, x.e, d)};
}

__device__ __forceinline__ Aff aff_shfl(const Aff& x, int src) {
  return Aff{__shfl_sync(FULL, x.a, src), __shfl_sync(FULL, x.b, src),
             __shfl_sync(FULL, x.c, src), __shfl_sync(FULL, x.e, src)};
}

// Per-group shared scratch for W > 1 (sized W entries each).
struct Exch {
  Aff* agg;     // warp aggregates of a scan
  float* bnd;   // 3 boundary values per warp
  float* red;   // warp partial sums
};

struct Group {
  int W;      // warps per item
  int warp;   // this warp's index in the group
  int lane;
  int t;      // thread index in the group
  int bar;    // the group's named barrier (W > 1): 0 when it is the block
  Exch x;
};

// Barrier of the W warps of a group (W > 1); other groups of the block
// do not take part.
__device__ __forceinline__ void group_sync(const Group& g) {
  asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(32 * g.W) : "memory");
}

// Scan of the threads' maps in lane order (REV: from the highest lane
// down).  Returns the composition of the maps of all threads before
// this one in chain order (`excl`) and of the whole group (`total`).
template <bool REV>
__device__ __forceinline__ void group_scan(const Group& g, Aff x, Aff& excl,
                                           Aff& total) {
  Aff inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (!REV) {
      Aff o = aff_shfl_up(inc, d);
      if (g.lane >= d) inc = aff_then(o, inc);
    } else {
      Aff o = aff_shfl_down(inc, d);
      if (g.lane + d < 32) inc = aff_then(o, inc);
    }
  }
  Aff ex = REV ? aff_shfl_down(inc, 1) : aff_shfl_up(inc, 1);
  if (g.lane == (REV ? 31 : 0)) ex = aff_identity();
  const Aff wtot = aff_shfl(inc, REV ? 0 : 31);
  if (g.W == 1) {
    excl = ex;
    total = wtot;
    return;
  }
  if (g.lane == 0) g.x.agg[g.warp] = wtot;
  group_sync(g);
  Aff pre = aff_identity(), tot = aff_identity();
  for (int s = 0; s < g.W; ++s) {
    const int w = REV ? g.W - 1 - s : s;
    const Aff v = g.x.agg[w];
    if (REV ? (w > g.warp) : (w < g.warp)) pre = aff_then(pre, v);
    tot = aff_then(tot, v);
  }
  excl = aff_then(pre, ex);
  total = tot;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

// The run's last value of three rows at lane k0-1 (the previous
// thread's, or the previous warp's for W > 1; 0 at lane -1).
__device__ __forceinline__ void lane_before(const Group& g, float a, float b,
                                            float c, float& pa, float& pb,
                                            float& pc) {
  if (g.W > 1) {
    if (g.lane == 31) {
      g.x.bnd[3 * g.warp] = a;
      g.x.bnd[3 * g.warp + 1] = b;
      g.x.bnd[3 * g.warp + 2] = c;
    }
    group_sync(g);
  }
  pa = __shfl_up_sync(FULL, a, 1);
  pb = __shfl_up_sync(FULL, b, 1);
  pc = __shfl_up_sync(FULL, c, 1);
  if (g.lane == 0) {
    if (g.warp == 0) {
      pa = pb = pc = 0.f;
    } else {
      pa = g.x.bnd[3 * (g.warp - 1)];
      pb = g.x.bnd[3 * (g.warp - 1) + 1];
      pc = g.x.bnd[3 * (g.warp - 1) + 2];
    }
  }
}

// lane_before for a segmented group (W > 1) at segment <s>: thread 0
// takes the previous segment's last lane, which that segment's last
// thread left in cx[4 ((s - 1) & 1)..] after the exchange (two buffers:
// a segment's writes never meet the reads of the one before), and 0 in
// segment 0.
__device__ __forceinline__ void lane_before_seg(const Group& g, float a,
                                                float b, float c, int s,
                                                float* cx, float& pa,
                                                float& pb, float& pc) {
  if (g.lane == 31) {
    g.x.bnd[3 * g.warp] = a;
    g.x.bnd[3 * g.warp + 1] = b;
    g.x.bnd[3 * g.warp + 2] = c;
  }
  group_sync(g);
  pa = __shfl_up_sync(FULL, a, 1);
  pb = __shfl_up_sync(FULL, b, 1);
  pc = __shfl_up_sync(FULL, c, 1);
  if (g.lane == 0) {
    if (g.warp > 0) {
      pa = g.x.bnd[3 * (g.warp - 1)];
      pb = g.x.bnd[3 * (g.warp - 1) + 1];
      pc = g.x.bnd[3 * (g.warp - 1) + 2];
    } else if (s == 0) {
      pa = pb = pc = 0.f;
    } else {
      const float* q = cx + 4 * ((s - 1) & 1);
      pa = q[0];
      pb = q[1];
      pc = q[2];
    }
  }
  if (g.t == 32 * g.W - 1) {
    float* q = cx + 4 * (s & 1);
    q[0] = a;
    q[1] = b;
    q[2] = c;
  }
}

// The sum of <v> over the group (W > 1), the same on every thread.
__device__ __forceinline__ float group_sum(const Group& g, float v) {
  v = warp_sum(v);
  if (g.lane == 0) g.x.red[g.warp] = v;
  group_sync(g);
  float r = 0.f;
  for (int w = 0; w < g.W; ++w) r += g.x.red[w];
  group_sync(g);
  return r;
}

// Where a block of a Forward-gate or decoding class keeps its model's
// tables (the class row's word 7, ops/multimodel.py f32_class_row):
// both in shared memory, only the transitions (the odds then come from
// L2), or neither.
enum Stage { STAGE_NONE = 0, STAGE_ALL = 1, STAGE_TRANS = 2 };

__host__ __device__ constexpr size_t staged_bytes(int Kp, int Mp, int stage) {
  return stage == STAGE_ALL     ? (size_t)(Kp + NTR) * Mp * sizeof(float)
         : stage == STAGE_TRANS ? (size_t)NTR * Mp * sizeof(float)
                                : 0;
}

// A group's exchange scratch (Exch), past the staged tables; a
// segmented group's carries (SEG_CARRY floats) after it.
__host__ __device__ constexpr size_t group_bytes(int W) {
  return (size_t)W * (sizeof(Aff) + 4 * sizeof(float));
}

constexpr int SEG_CARRY = 8;

// Bytes of a segmented group's slot (plan.cuh): the M, I and D rows of
// its Mp lanes (the Backward's M, I and emitted M), f32.
__host__ __device__ constexpr size_t dp_seg_slot_bytes(int Mp) {
  return (size_t)3 * Mp * sizeof(float);
}

// Stages the padded tables ([Kp][Mp] odds, [NTR][Mp] transitions) in
// shared memory as <stage> says; every thread of the block calls it,
// and the block syncs when anything was staged.  Returns the tables to
// read.
__device__ __forceinline__ void load_tables(const float* __restrict__ etab_g,
                                            const float* __restrict__ ttab_g,
                                            int Kp, int Mp, float* smem,
                                            int stage, const float*& etab,
                                            const float*& ttab) {
  etab = etab_g;
  ttab = ttab_g;
  if (stage == STAGE_NONE) return;
  const int ne = stage == STAGE_ALL ? Kp * Mp : 0, nt = NTR * Mp;
  for (int q = threadIdx.x; q < ne; q += blockDim.x) smem[q] = etab_g[q];
  for (int q = threadIdx.x; q < nt; q += blockDim.x) smem[ne + q] = ttab_g[q];
  __syncthreads();
  if (stage == STAGE_ALL) etab = smem;
  ttab = smem + ne;
}

// Transition row r at lane k; lanes at or past Mp read 0.
__device__ __forceinline__ float trv(const float* ttab, int Mp, int r, int k) {
  return k < Mp ? ttab[r * Mp + k] : 0.f;
}

// The forward pass over one item's `len` residues.  STORE (decoding)
// rescales sparsely (only when xE > 1e4, the host kernel's cadence) and
// writes the six specials of every row to `spec` (6 rows of stride
// ld); the gate rescales every row by max(xE, 1).  Returns the Forward
// score in nats and, in `lsf`, the total log scale.  The log scale is
// summed in double: at scores of hundreds of nats an f32 sum rounds at
// ~1e-4, which the posterior weights exp(logw - logZ) would inherit.
template <int P, bool STORE>
__device__ double forward_pass(const Group& g, const float* etab,
                               const float* ttab, int Mp,
                               const int8_t* __restrict__ seq, int len,
                               float pmove, float nj, double* spec, int ld,
                               double& lsf) {
  const int k0 = g.t * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  float m[P], iv[P], d[P];
#pragma unroll
  for (int j = 0; j < P; ++j) m[j] = iv[j] = d[j] = 0.f;
  float xN = 1.f, xJ = 0.f, xC = 0.f, xB = pmove;
  double lacc = 0.0, score = -INFINITY;
  if (STORE && g.t == 0) {
    spec[0] = pmove;
    spec[ld] = 1.f;
    spec[2 * ld] = spec[3 * ld] = spec[4 * ld] = spec[5 * ld] = 0.f;
  }
  for (int i = 0; i < len; ++i) {
    const float* e = etab + (int)seq[i] * Mp + k0;
    // the previous row at lane k0-1
    float mp, ip, dp;
    lane_before(g, m[P - 1], iv[P - 1], d[P - 1], mp, ip, dp);
    // M and I rows in place, high lane first (lane j reads j-1's old row)
    float sumsv = 0.f;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const int k = k0 + j;
      const float mm = j ? m[j - 1] : mp;
      const float ii = j ? iv[j - 1] : ip;
      const float dd = j ? d[j - 1] : dp;
      const float sv = (xB * ttab[P_BM * Mp + k] + mm * ttab[P_MM * Mp + k] +
                        ii * ttab[P_IM * Mp + k] + dd * ttab[P_DM * Mp + k]) *
                       e[j];
      iv[j] = m[j] * ttab[P_MI * Mp + k] + iv[j] * ttab[P_II * Mp + k];
      m[j] = sv;
      sumsv += sv;
    }
    // this run's D chain as a map of its carry D[k0]
    float coef = 1.f, val = 0.f, sc = 1.f, se = 0.f;
#pragma unroll
    for (int j = 1; j < P; ++j) {
      const int k = k0 + j;
      const float tdd = ttab[P_DD * Mp + k];
      val = ttab[P_MD * Mp + k] * m[j - 1] + tdd * val;
      coef *= tdd;
      sc += coef;
      se += val;
    }
    const float tddn = trv(ttab, Mp, P_DD, k0 + P);
    const float tmdn = trv(ttab, Mp, P_MD, k0 + P);
    Aff loc{tddn * coef, tmdn * m[P - 1] + tddn * val, sc, se + sumsv};
    Aff ex, tot;
    group_scan<false>(g, loc, ex, tot);
    const float xE = tot.e;
    d[0] = ex.b;
#pragma unroll
    for (int j = 1; j < P; ++j) {
      const int k = k0 + j;
      d[j] = ttab[P_MD * Mp + k] * m[j - 1] + ttab[P_DD * Mp + k] * d[j - 1];
    }
    const float xN2 = xN * ploop;
    const float xC2 = xC * ploop + xE * emove;
    const float xJ2 = xJ * ploop + xE * eloop;
    const float xB2 = xJ2 * pmove + xN2 * pmove;
    const float s = STORE ? (xE > 1.0e4f ? xE : 1.f) : fmaxf(xE, 1.f);
    const float sinv = 1.f / s;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      m[j] *= sinv;
      iv[j] *= sinv;
      d[j] *= sinv;
    }
    xN = xN2 * sinv;
    xJ = xJ2 * sinv;
    xC = xC2 * sinv;
    xB = xB2 * sinv;
    lacc += (double)logf(s);
    if (i == len - 1) score = lacc + (double)logf(xC * pmove);
    if (STORE && g.t == 0) {
      double* r = spec + i + 1;
      r[0] = xB;
      r[ld] = xN;
      r[2 * ld] = xJ;
      r[3 * ld] = xC;
      r[4 * ld] = xE * sinv;
      r[5 * ld] = lacc;
    }
  }
  lsf = lacc;
  return score;
}

// forward_pass for a segmented group: each row in S segments of 32 W P
// lanes, a lane's M, I and D waiting in <slot> between them (rows v = 0,
// 1, 2 of segment s, lane j of thread t at ((3 s + v) P + j) 32 W + t),
// stored before the row's rescale, which the next row applies as it
// loads them.  The D chain enters each segment at the carry the last
// one's scan total gives; xE sums the segments' totals.  <cx>: the
// group's carries (lane_before_seg).
template <int P, bool STORE>
__device__ double forward_pass_seg(const Group& g, const float* etab,
                                   const float* ttab, int Mp, int S,
                                   const int8_t* __restrict__ seq, int len,
                                   float pmove, float nj, double* spec,
                                   int ld, double& lsf, float* slot,
                                   float* cx) {
  const int NT = 32 * g.W, SEG = NT * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  float xN = 1.f, xJ = 0.f, xC = 0.f, xB = pmove;
  float scale = 1.f;          // the previous row's rescale, not yet applied
  double lacc = 0.0, score = -INFINITY;
  if (STORE && g.t == 0) {
    spec[0] = pmove;
    spec[ld] = 1.f;
    spec[2 * ld] = spec[3 * ld] = spec[4 * ld] = spec[5 * ld] = 0.f;
  }
  for (int i = 0; i < len; ++i) {
    const int res = (int)seq[i];
    float xE = 0.f, dcarry = 0.f;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 3 * SEG + g.t;
      float m[P], iv[P], d[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        m[j] = i ? st[j * NT] * scale : 0.f;
        iv[j] = i ? st[SEG + j * NT] * scale : 0.f;
        d[j] = i ? st[2 * SEG + j * NT] * scale : 0.f;
      }
      const float* e = etab + res * Mp + k0;
      float mp, ip, dp;
      lane_before_seg(g, m[P - 1], iv[P - 1], d[P - 1], s, cx, mp, ip, dp);
      float sumsv = 0.f;
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int k = k0 + j;
        const float mm = j ? m[j - 1] : mp;
        const float ii = j ? iv[j - 1] : ip;
        const float dd = j ? d[j - 1] : dp;
        const float sv = (xB * ttab[P_BM * Mp + k] + mm * ttab[P_MM * Mp + k] +
                          ii * ttab[P_IM * Mp + k] + dd * ttab[P_DM * Mp + k]) *
                         e[j];
        iv[j] = m[j] * ttab[P_MI * Mp + k] + iv[j] * ttab[P_II * Mp + k];
        m[j] = sv;
        sumsv += sv;
      }
      float coef = 1.f, val = 0.f, sc = 1.f, se = 0.f;
#pragma unroll
      for (int j = 1; j < P; ++j) {
        const int k = k0 + j;
        const float tdd = ttab[P_DD * Mp + k];
        val = ttab[P_MD * Mp + k] * m[j - 1] + tdd * val;
        coef *= tdd;
        sc += coef;
        se += val;
      }
      const float tddn = trv(ttab, Mp, P_DD, k0 + P);
      const float tmdn = trv(ttab, Mp, P_MD, k0 + P);
      Aff loc{tddn * coef, tmdn * m[P - 1] + tddn * val, sc, se + sumsv};
      Aff ex, tot;
      group_scan<false>(g, loc, ex, tot);
      d[0] = fmaf(ex.a, dcarry, ex.b);
#pragma unroll
      for (int j = 1; j < P; ++j) {
        const int k = k0 + j;
        d[j] = ttab[P_MD * Mp + k] * m[j - 1] + ttab[P_DD * Mp + k] * d[j - 1];
      }
      xE += fmaf(tot.c, dcarry, tot.e);
      dcarry = fmaf(tot.a, dcarry, tot.b);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        st[j * NT] = m[j];
        st[SEG + j * NT] = iv[j];
        st[2 * SEG + j * NT] = d[j];
      }
    }
    const float xN2 = xN * ploop;
    const float xC2 = xC * ploop + xE * emove;
    const float xJ2 = xJ * ploop + xE * eloop;
    const float xB2 = xJ2 * pmove + xN2 * pmove;
    const float sc = STORE ? (xE > 1.0e4f ? xE : 1.f) : fmaxf(xE, 1.f);
    const float sinv = 1.f / sc;
    scale = sinv;
    xN = xN2 * sinv;
    xJ = xJ2 * sinv;
    xC = xC2 * sinv;
    xB = xB2 * sinv;
    lacc += (double)logf(sc);
    if (i == len - 1) score = lacc + (double)logf(xC * pmove);
    if (STORE && g.t == 0) {
      double* r = spec + i + 1;
      r[0] = xB;
      r[ld] = xN;
      r[2 * ld] = xJ;
      r[3 * ld] = xC;
      r[4 * ld] = xE * sinv;
      r[5 * ld] = lacc;
    }
  }
  lsf = lacc;
  return score;
}

}  // namespace bt

// Carves a group's exchange scratch out of the dynamic shared memory,
// <at_floats> floats in (past the staged tables and the groups before
// it).
__device__ __forceinline__ bt::Group bt_group(int W, float* smem,
                                              size_t at_floats) {
  bt::Group g;
  g.W = W;
  g.warp = (threadIdx.x >> 5) % W;
  g.lane = threadIdx.x & 31;
  g.t = g.warp * 32 + g.lane;
  g.bar = 0;
  float* base = smem + at_floats;
  g.x.agg = reinterpret_cast<bt::Aff*>(base);
  g.x.bnd = base + 4 * W;
  g.x.red = base + 7 * W;
  return g;
}

// Host side: checks the classes of a Forward-gate or decoding plan (the
// host copy of the table; plan.cuh, the class row: the stacked tables'
// addresses, P, W, Mp, G, Kp, stage, the segments S and a segmented
// class's scratch) and gives the launch's largest P, whether a class is
// segmented (then blocks of the segmented group's 16 warps), and the
// dynamic shared memory.  Returns 0, or a cudaError_t.
static inline int bt_plan_check(const long long* plan, int ncls, int warps,
                                int& pmax, bool& seg, size_t& smem) {
  const int cap = plan_smem_optin();
  if (ncls <= 0 || warps <= 0 || warps > 32) return cudaErrorInvalidValue;
  pmax = 0;
  seg = false;
  smem = 0;
  for (int i = 0; i < ncls; ++i) {
    const long long* c = plan + PLAN_CLS * i;
    const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], G = (int)c[5];
    const int Kp = (int)c[6], stage = (int)c[7], S = (int)c[8];
    if (!(P == 3 || P == 5 || P == 9 || P == 13 || P == 17 || P == 25 ||
          P == 33) ||
        W < 1 || S < 1 || Mp != 32 * P * W * S || G < 1 || G * W > warps ||
        (W > 1 && G > 15) || Kp < 1 || stage < 0 || stage > 2 ||
        (S > 1 && (W < 2 || G != 1 || c[9] == 0 || stage != 0)))
      return cudaErrorInvalidValue;
    const size_t need =
        bt::staged_bytes(Kp, Mp, stage) + (size_t)G * bt::group_bytes(W) +
        (S > 1 ? bt::SEG_CARRY * sizeof(float) : 0);
    smem = need > smem ? need : smem;
    pmax = P > pmax ? P : pmax;
    seg = seg || S > 1;
  }
  if (seg && warps > 16) return cudaErrorInvalidValue;
  return smem <= (size_t)cap ? 0 : cudaErrorInvalidValue;
}
