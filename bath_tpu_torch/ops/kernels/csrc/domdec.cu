// Forward + Backward parser for domain decoding of the F3 survivors.
//
// Replaces bath_tpu/ops/jaxk/kernels.py _domdec_mb_impl (the jnp
// kernel that the TPU runs for p7_BackwardParser + p7_DomainDecoding)
// and bath_tpu/ops/jaxk/multimodel.py domdec_pack_batch
// (build_domdec_pack: item b decoded under model slot[b]; the TPU's lane
// packing is not carried over).  Per ORF: the forward pass that stores
// the six specials of every row (forward_pass<P, true>, shared with the
// gate: xB, xN, xJ, xC, xE after the row's rescale and the log scale
// through the row), and the backward pass, whose D->D chain is a suffix
// scan along k, storing its own six specials of every row the same way.
// The combine into the posterior increments of domain begin, end and
// N/J/C occupancy, their exp(logw - logZ) weights, the cumsum over rows
// and the `ok` test run as tensor ops after the kernel (ops/domdec.py
// finish_passes).
//
// What bounds it on the H100: a latency chain of dependent rows per
// ORF, each with a group-wide reduction (xB) or scan; the host-side
// cadence of the rescaling (forward xE > 1e4, backward xB outside
// [1e-4, 1e4]) is kept so the posteriors track the host kernel to
// ~1e-5.  The design:
// - The two passes share no data (each writes its own specials), so an
//   ORF takes two groups, one a pass, which run at the same time: the
//   chain is L + 1 rows, not 2L + 1.
// - One launch for every padded width of a call (plan.cuh; ops/
//   multimodel.py domdec_plan), blocks longest ORF first, so a call
//   takes about its longest chain and not the sum over its widths.  A
//   single-model call is a plan of one class.
// - Decoding sees small batches (the F3 survivors of a flush, ~100), so
//   the plan gives a small batch's groups blocks of their own across the
//   SMs, each warp with a scheduler to itself; a block stages its
//   model's tables in shared memory (the class row says whether they
//   fit).  Groups of W > 1 warps sync on a named barrier of their own.
// - A block of more warps than the kernel's registers let launch (255 a
//   thread: past eight warps of 33 lanes an ORF, M = 8448) takes a wide
//   instance capped at 64 registers a thread, up to a block's 32 warps.
// - A longer model takes a group of 16 warps that walks each row in S
//   segments (dp_common.cuh): the Forward as the gate's, the Backward in
//   two walks a row (backward_pass_seg), in an instance of its own
//   (blocks of 512 threads; beside a class of more warps, 1024).
// - The wide and segmented instances are compiled in a translation unit
//   of their own, domdec_wide.cu, which includes this file with
//   BT_DOMDEC_WIDE defined, so that they compile beside the other (one
//   nvcc a source).

#include "dp_common.cuh"
#include "plan.cuh"

namespace bt {

// The backward pass over one item's `len` residues, rows len down to 0.
// Row j's M/I/D hold the backward values of the model states after
// residue j; row j's xB reads row j+1's M (the emission of residue j+1).
// Stores per row xB, xN, xJ, xC, xE after the row's rescale and the log
// scale through the row (6 rows of stride ld).
template <int P>
__device__ void backward_pass(const Group& g, const float* etab,
                              const float* ttab, int M, int Mp,
                              const int8_t* __restrict__ seq, int len,
                              float pmove, float nj, double* spec, int ld) {
  const int k0 = g.t * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  float m[P], iv[P], d[P];
  // row L: xC = pmove, xE = xC*emove into every M and (via the suffix
  // D closure and M->D) D state
  const float xE_L = pmove * emove;
  {
#pragma unroll
    for (int j = 0; j < P; ++j) d[j] = (k0 + j < M) ? xE_L : 0.f;
    float coef = 1.f, val = 0.f;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float a = trv(ttab, Mp, P_DD, k0 + j + 1);
      val = d[j] + a * val;
      coef *= a;
    }
    Aff ex, tot;
    group_scan<true>(g, Aff{coef, val, 0.f, 0.f}, ex, tot);
    float nxt = ex.b;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float pre = d[j];
      m[j] = pre + nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
      const float nd = pre + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
      nxt = nd;
      iv[j] = 0.f;
    }
  }
  float xNb = 0.f, xJb = 0.f, xCb = pmove;
  double lsb = 0.0;
  if (g.t == 0) {
    double* r = spec + len;
    r[0] = r[ld] = r[2 * ld] = r[5 * ld] = 0.0;
    r[3 * ld] = pmove;
    r[4 * ld] = xE_L;
  }
  for (int q = 0; q < len; ++q) {
    const int jrow = len - q;                 // the row after this one
    const float* e = etab + (int)seq[jrow - 1] * Mp + k0;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      m[j] *= e[j];                           // M* = M_b * emission
      part += ttab[P_BM * Mp + k0 + j] * m[j];
    }
    part = warp_sum(part);
    // next lane's M* (lane k0+P) for this run's last lane
    float nms = __shfl_down_sync(FULL, m[0], 1);
    float xBn = part;
    if (g.W > 1) {
      if (g.lane == 0) {
        g.x.red[g.warp] = part;
        g.x.bnd[3 * g.warp] = m[0];
      }
      group_sync(g);
      xBn = 0.f;
      for (int w = 0; w < g.W; ++w) xBn += g.x.red[w];
      if (g.lane == 31) {
        if (g.warp + 1 < g.W)
          nms = g.x.bnd[3 * (g.warp + 1)];
        else
          nms = 0.f;
      }
    } else if (g.lane == 31) {
      nms = 0.f;
    }
    const float xCn = xCb * ploop;
    const float xJn = xBn * pmove + xJb * ploop;
    const float xNn = xBn * pmove + xNb * ploop;
    const float xEn = xCn * emove + xJn * eloop;
    // I and M (before the D term) in place, low lane first; d = the
    // D chain's input
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j;
      const float ms1 = j + 1 < P ? m[j + 1] : nms;
      const bool real = k < M;
      const float ni = iv[j] * ttab[P_II * Mp + k] + ms1 * trv(ttab, Mp, P_IM, k + 1);
      const float nm = iv[j] * ttab[P_MI * Mp + k] + ms1 * trv(ttab, Mp, P_MM, k + 1);
      d[j] = real ? ms1 * trv(ttab, Mp, P_DM, k + 1) + xEn : 0.f;
      m[j] = real ? nm + xEn : 0.f;
      iv[j] = ni;
    }
    // suffix D chain: D[k] = pre[k] + tDD[k+1] * D[k+1]
    float coef = 1.f, val = 0.f;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float a = trv(ttab, Mp, P_DD, k0 + j + 1);
      val = d[j] + a * val;
      coef *= a;
    }
    Aff ex, tot;
    group_scan<true>(g, Aff{coef, val, 0.f, 0.f}, ex, tot);
    float nxt = ex.b;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      m[j] += nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
      nxt = d[j] + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
    }
    const float sb =
        (xBn > 0.f && (xBn > 1.0e4f || xBn < 1.0e-4f)) ? xBn : 1.f;
    const float sbi = 1.f / sb;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      m[j] *= sbi;
      iv[j] *= sbi;
    }
    xNb = xNn * sbi;
    xJb = xJn * sbi;
    xCb = xCn * sbi;
    lsb += (double)logf(sb);
    if (g.t == 0) {
      double* r = spec + jrow - 1;
      r[0] = xBn * sbi;
      r[ld] = xNb;
      r[2 * ld] = xJb;
      r[3 * ld] = xCb;
      r[4 * ld] = xEn * sbi;
      r[5 * ld] = lsb;
    }
  }
}

// backward_pass for a segmented group: each row in S segments of 32 W
// P lanes, in two walks.  The first (segments in order) emits: M* = M_b
// x the emission of the row's residue, and the partial sums of xB; the
// second (segments from the last) takes xB's total and closes the
// suffix D chain, the carry entering each segment from the one after
// it, and rescales.  Between walks and rows a lane's M_b, I and M* wait
// in <slot> (rows v = 0, 1, 2 of segment s, lane j of thread t at
// ((3 s + v) P + j) 32 W + t); the last lane of a segment reads the next
// segment's first M* there.
template <int P>
__device__ void backward_pass_seg(const Group& g, const float* etab,
                                  const float* ttab, int M, int Mp, int S,
                                  const int8_t* __restrict__ seq, int len,
                                  float pmove, float nj, double* spec, int ld,
                                  float* slot) {
  const int NT = 32 * g.W, SEG = NT * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  const float xE_L = pmove * emove;
  float carry = 0.f;
  for (int s = S - 1; s >= 0; --s) {
    const int k0 = s * SEG + g.t * P;
    float* st = slot + (size_t)s * 3 * SEG + g.t;
    float d[P];
#pragma unroll
    for (int j = 0; j < P; ++j) d[j] = (k0 + j < M) ? xE_L : 0.f;
    float coef = 1.f, val = 0.f;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float a = trv(ttab, Mp, P_DD, k0 + j + 1);
      val = d[j] + a * val;
      coef *= a;
    }
    Aff ex, tot;
    group_scan<true>(g, Aff{coef, val, 0.f, 0.f}, ex, tot);
    float nxt = fmaf(ex.a, carry, ex.b);
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float pre = d[j];
      st[j * NT] = pre + nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
      nxt = pre + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
      st[SEG + j * NT] = 0.f;
    }
    carry = fmaf(tot.a, carry, tot.b);
  }
  float xNb = 0.f, xJb = 0.f, xCb = pmove;
  double lsb = 0.0;
  if (g.t == 0) {
    double* r = spec + len;
    r[0] = r[ld] = r[2 * ld] = r[5 * ld] = 0.0;
    r[3 * ld] = pmove;
    r[4 * ld] = xE_L;
  }
  for (int q = 0; q < len; ++q) {
    const int jrow = len - q;                 // the row after this one
    const int res = (int)seq[jrow - 1];
    float part = 0.f;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 3 * SEG + g.t;
      const float* e = etab + res * Mp + k0;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float ms = st[j * NT] * e[j];   // M* = M_b * emission
        part += ttab[P_BM * Mp + k0 + j] * ms;
        st[2 * SEG + j * NT] = ms;
      }
    }
    const float xBn = group_sum(g, part);
    const float xCn = xCb * ploop;
    const float xJn = xBn * pmove + xJb * ploop;
    const float xNn = xBn * pmove + xNb * ploop;
    const float xEn = xCn * emove + xJn * eloop;
    const float sb =
        (xBn > 0.f && (xBn > 1.0e4f || xBn < 1.0e-4f)) ? xBn : 1.f;
    const float sbi = 1.f / sb;
    carry = 0.f;
    for (int s = S - 1; s >= 0; --s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 3 * SEG + g.t;
      float m[P], iv[P], d[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        m[j] = st[2 * SEG + j * NT];
        iv[j] = st[SEG + j * NT];
      }
      // the next lane's M* (lane k0+P) for this run's last lane
      float nms = __shfl_down_sync(FULL, m[0], 1);
      if (g.lane == 0) g.x.bnd[3 * g.warp] = m[0];
      group_sync(g);
      if (g.lane == 31)
        nms = g.warp + 1 < g.W ? g.x.bnd[3 * (g.warp + 1)]
              : s + 1 < S      ? slot[(size_t)(3 * (s + 1) + 2) * SEG]
                               : 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + j;
        const float ms1 = j + 1 < P ? m[j + 1] : nms;
        const bool real = k < M;
        const float ni =
            iv[j] * ttab[P_II * Mp + k] + ms1 * trv(ttab, Mp, P_IM, k + 1);
        const float nm =
            iv[j] * ttab[P_MI * Mp + k] + ms1 * trv(ttab, Mp, P_MM, k + 1);
        d[j] = real ? ms1 * trv(ttab, Mp, P_DM, k + 1) + xEn : 0.f;
        m[j] = real ? nm + xEn : 0.f;
        iv[j] = ni;
      }
      float coef = 1.f, val = 0.f;
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const float a = trv(ttab, Mp, P_DD, k0 + j + 1);
        val = d[j] + a * val;
        coef *= a;
      }
      Aff ex, tot;
      group_scan<true>(g, Aff{coef, val, 0.f, 0.f}, ex, tot);
      float nxt = fmaf(ex.a, carry, ex.b);
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        m[j] += nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
        nxt = d[j] + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
      }
      carry = fmaf(tot.a, carry, tot.b);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        st[j * NT] = m[j] * sbi;
        st[SEG + j * NT] = iv[j] * sbi;
      }
    }
    xNb = xNn * sbi;
    xJb = xJn * sbi;
    xCb = xCn * sbi;
    lsb += (double)logf(sb);
    if (g.t == 0) {
      double* r = spec + jrow - 1;
      r[0] = xBn * sbi;
      r[ld] = xNb;
      r[2 * ld] = xJb;
      r[3 * ld] = xCb;
      r[4 * ld] = xEn * sbi;
      r[5 * ld] = lsb;
    }
  }
}

// The group's pass over its ORF b: the Forward writes fspec and logz2,
// the Backward bspec.  SEG and S > 1: the segmented walks, on <slot>
// and <cx>.
template <int P, bool SEG = false>
__device__ void decode_pass(const Group& g, const float* etab,
                            const float* ttab, int M, int Mp, int b,
                            int pass, const int8_t* __restrict__ dsq,
                            const int* __restrict__ lens, int L, float nj,
                            double* __restrict__ fspec,
                            double* __restrict__ bspec,
                            double* __restrict__ logz2, int S = 1,
                            float* slot = nullptr, float* cx = nullptr) {
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)len + 2.f + nj);
  const int ld = L + 1;
  const int8_t* seq = dsq + (size_t)b * L;
  if constexpr (SEG) {
    if (S > 1) {
      if (pass == 0) {
        double lsf;
        const double logz = forward_pass_seg<P, true>(
            g, etab, ttab, Mp, S, seq, len, pmove, nj,
            fspec + (size_t)b * 6 * ld, ld, lsf, slot, cx);
        if (g.t == 0) {
          logz2[2 * b] = logz;
          logz2[2 * b + 1] = lsf;
        }
      } else {
        backward_pass_seg<P>(g, etab, ttab, M, Mp, S, seq, len, pmove, nj,
                             bspec + (size_t)b * 6 * ld, ld, slot);
      }
      return;
    }
  }
  if (pass == 0) {
    double lsf;
    const double logz = forward_pass<P, true>(
        g, etab, ttab, Mp, seq, len, pmove, nj, fspec + (size_t)b * 6 * ld,
        ld, lsf);
    if (g.t == 0) {
      logz2[2 * b] = logz;
      logz2[2 * b + 1] = lsf;
    }
  } else {
    backward_pass<P>(g, etab, ttab, M, Mp, seq, len, pmove, nj,
                     bspec + (size_t)b * 6 * ld, ld);
  }
}

}  // namespace bt

// The class row of the plan (plan.cuh): the addresses of the class's
// stacked tables etab [g][Kp][Mp] and ttab [g][8][Mp] f32, P, W, Mp, G,
// Kp, where a block keeps the tables (bt::Stage), the segments S and a
// segmented class's scratch (SEG).  The items are 2b + pass: pass 0 the
// Forward, 1 the Backward.
template <bool SEG = false>
__device__ __forceinline__ void domdec_block(
    const int8_t* __restrict__ dsq, const int* __restrict__ lens, int L,
    float nj, double* __restrict__ fspec, double* __restrict__ bspec,
    double* __restrict__ logz2, const long long* __restrict__ plan, int ncls,
    int nblk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const PlanBlock pb = plan_block(plan, ncls, nblk);
  const long long* c = pb.cls;
  const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], Kp = (int)c[6];
  const int stage = (int)c[7];
  const float *etab, *ttab;
  bt::load_tables(
      reinterpret_cast<const float*>(c[0]) + (size_t)pb.model * Kp * Mp,
      reinterpret_cast<const float*>(c[1]) + (size_t)pb.model * bt::NTR * Mp,
      Kp, Mp, smem, stage, etab, ttab);
  if (pb.item < 0) return;
  const size_t at = bt::staged_bytes(Kp, Mp, stage) +
                    pb.gi * bt::group_bytes(W);
  bt::Group g = bt_group(W, smem, at / sizeof(float));
  g.bar = 1 + pb.gi;
  const int b = pb.item / 2, pass = pb.item % 2;
  // a segmented class: one group a block, which takes a slot of the
  // class's scratch, its carries past the group's scratch
  const int S = SEG ? (int)c[8] : 1;
  float* cx = reinterpret_cast<float*>(g.x.agg) + 8 * W;
  float* slot = nullptr;
  int sid = 0;
  if (SEG && S > 1)
    slot = reinterpret_cast<float*>(seg_take(
        c, bt::dp_seg_slot_bytes(Mp), reinterpret_cast<int*>(cx), sid));
#define BT_DECODE(PP)                                                       \
  bt::decode_pass<PP, SEG>(g, etab, ttab, pb.M, Mp, b, pass, dsq, lens, L,  \
                           nj, fspec, bspec, logz2, S, slot, cx);           \
  break;
  switch (P) {  // the plan's classes are checked on the host (bt_plan_check)
    case 3: BT_DECODE(3)
    case 5: BT_DECODE(5)
    case 9: BT_DECODE(9)
    case 13: BT_DECODE(13)
    case 17: BT_DECODE(17)
    case 25: BT_DECODE(25)
    case 33: BT_DECODE(33)
  }
#undef BT_DECODE
  if (SEG && S > 1) seg_free(c, sid);
}

#define DOMDEC_ARGS                                                        \
  const int8_t *__restrict__ dsq, const int *__restrict__ lens, int L,     \
      float nj, double *__restrict__ fspec, double *__restrict__ bspec,    \
      double *__restrict__ logz2, const long long *__restrict__ plan,      \
      int ncls, int nblk

#define DOMDEC_CALL                                                        \
  (const int8_t*)dsq, (const int*)lens, L, nj, (double*)fspec,             \
      (double*)bspec, (double*)logz2, (const long long*)plan, ncls, nblk

namespace bt {
// Launches domdec_wide_kernel or (seg) domdec_seg_kernel
// (domdec_wide.cu).
int domdec_wide_launch(bool seg, const void* dsq, const void* lens, int L,
                       float nj, void* fspec, void* bspec, void* logz2,
                       const void* plan, int ncls, int nblk, int warps,
                       size_t smem, void* stream);
}  // namespace bt

#ifndef BT_DOMDEC_WIDE
__global__ void domdec_kernel(DOMDEC_ARGS) {
  domdec_block(dsq, lens, L, nj, fspec, bspec, logz2, plan, ncls, nblk);
}
#undef DOMDEC_ARGS

// dsq [B, L] int8; lens [B] int32; fspec and bspec [B, 6, L+1] f64,
// zero-filled by the caller (rows past an item stay 0): per row xB, xN,
// xJ, xC, xE after the row's rescale and the log scale through the row,
// of the forward and of the backward pass; logz2 [B, 2] f64 = (logZ,
// total forward log scale); written at the plan's items.  plan_host and
// plan: the plan's table (plan.cuh, the class row above) on the host
// and on the device, with ncls classes and nblk blocks of `warps`
// warps, two items an ORF.  One entry serves the single-model calls
// (J1) and the multi-model ones (J3b).  Returns the launch's
// cudaError_t.
extern "C" int bt_domdec(const void* dsq, const void* lens, int L, float nj,
                         void* fspec, void* bspec, void* logz2,
                         const long long* plan_host, const void* plan,
                         int ncls, int nblk, int warps, void* stream) {
  if (nblk <= 0) return 0;
  int pmax;
  bool seg;
  size_t smem;
  const int err = bt_plan_check(plan_host, ncls, warps, pmax, seg, smem);
  if (err) return err;
  static int most[64];  // domdec_kernel's most threads a block, per device
  int dev = 0;
  cudaGetDevice(&dev);
  int& m = most[dev & 63];
  if (!m) {
    cudaFuncAttributes a;
    m = cudaFuncGetAttributes(&a, domdec_kernel) == cudaSuccess
            ? a.maxThreadsPerBlock
            : -1;
  }
  if (seg || 32 * warps > m)
    return bt::domdec_wide_launch(seg, dsq, lens, L, nj, fspec, bspec, logz2,
                                  plan, ncls, nblk, warps, smem, stream);
  cudaFuncSetAttribute(domdec_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  domdec_kernel<<<nblk, 32 * warps, smem,
                  reinterpret_cast<cudaStream_t>(stream)>>>(DOMDEC_CALL);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_domdec_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(bt::dp_seg_slot_bytes(Mp), n);
}
#else
// A block of more warps than domdec_kernel's registers let launch (a
// class of more than eight warps an ORF, past M = 8448; up to 32): the
// same code at most 64 registers a thread.
__global__ void __launch_bounds__(1024) domdec_wide_kernel(DOMDEC_ARGS) {
  domdec_block(dsq, lens, L, nj, fspec, bspec, logz2, plan, ncls, nblk);
}

// A launch with a segmented class (a model past 32 warps of 33 lanes):
// blocks of its group's 16 warps (the plan segments any class of more
// warps beside it).
__global__ void __launch_bounds__(512) domdec_seg_kernel(DOMDEC_ARGS) {
  domdec_block<true>(dsq, lens, L, nj, fspec, bspec, logz2, plan, ncls,
                     nblk);
}
#undef DOMDEC_ARGS

int bt::domdec_wide_launch(bool seg, const void* dsq, const void* lens,
                           int L, float nj, void* fspec, void* bspec,
                           void* logz2, const void* plan, int ncls, int nblk,
                           int warps, size_t smem, void* stream) {
  const auto kernel = seg ? domdec_seg_kernel : domdec_wide_kernel;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<nblk, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      DOMDEC_CALL);
  return (int)cudaGetLastError();
}
#endif
#undef DOMDEC_CALL
