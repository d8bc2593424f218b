// Shared device code of the fs3-Forward gate and fs3 decoding kernels:
// the frameshift 3-codon Forward over one DNA window.
//
// Layout and D->D scan are those of dp_common.cuh (a group of W warps
// per window, P consecutive model lanes per thread in registers, the
// D chain as a scan of per-thread affine maps).  What the fs3
// recurrence adds, per row i (1-based nucleotide):
//
//   sv[k]  = xB(i-2) tBM[k] + M(i-2)[k-1] tMM[k] + I(i-2)[k-1] tIM[k]
//            + D(i-2)[k-1] tDM[k]                (the IVX entry row)
//   M(i)   = sv E2(i) + sv(i-1) E3(i) + sv(i-2) E4(i)
//   I(i)   = M(i-3) tMI + I(i-3) tII
//   D(i)   = the chain tMD[k] M(i)[k-1] + tDD[k] D(i)[k-1]
//
// with E2/E3/E4 the odds of the 2-, 3- and 4-nt codon ending at row i,
// and N/J/C looping every 3 rows.  The rows are never kept as M/I/D:
// a thread keeps, for its lanes, Q(r) = the k-1 sum that row r+2 reads
// (2 rows), N(r) = M(r) tMI + I(r) tII that row r+3 reads (3 rows) and
// sv(r) (2 rows): 7P floats.  Each row is stored unscaled, in the frame
// in which it was computed, with one factor per row that brings it to
// the current frame; a rescale touches three scalars instead of 7P
// registers.  The rings rotate by renaming: six rows are unrolled, each
// one step() with the arrays in rotated roles (lcm of the 2- and 3-row
// rings), so no row is ever copied.
//
// The emission table (338 packed codon rows x Mp lanes, 0.5 MB at
// M = 400) does not fit in shared memory.  A row's three codon rows
// depend only on the window's nucleotides, known before the pass, so
// they are fetched a row ahead of the row that reads them (Fs3Ring): one
// thread of the group asks the copy engine for the next row's three
// codon rows (cp.async.bulk, Mp floats each) into the other slot of a
// two-slot ring in shared memory, and the group waits on that slot's
// mbarrier only when it gets there.  The consumers read no nucleotide
// and no global memory in the row; the producer reads its next
// nucleotide a row before it needs it.  The direct loads are the other
// path (the class row's word 6): every thread keeps the producer's
// nucleotides and reads its lanes of the row's three codon rows straight
// from global memory (L2).  They serve a launch of narrow classes only
// (P <= 5, where the ring's handshake costs more than it hides) and a
// model past eight warps (M = 3328), whose instance caps its registers;
// past M = 3744, where a group's ring does not fit a block, its
// transitions stay in global memory too (word 7).  A model past 32
// warps of 13 lanes (M = 13312) is segmented (dp_common.cuh): a group of
// 16 warps walks each row in S segments on the direct loads, the rings'
// rows waiting in the block's slot of the class's scratch (plan.cuh
// seg_take) between segments
// (fs3_forward_pass_seg, fs3_domdec.cu fs3_backward_pass_seg).

#pragma once

#include "dp_common.cuh"
#include "plan.cuh"

namespace bt {

constexpr int FS3_PLACE = 338;      // nucleotide >= 4 or before the window
constexpr int FS3_DEGEN_C = 336;
constexpr int FS3_DEGEN_QC1 = 337;
constexpr int FS3_RING = 2;         // emission-row ring slots a group

__device__ __forceinline__ int fs3_nt(int8_t r) {
  return r < 4 ? (int)r : FS3_PLACE;
}

// packed codon indices (constants.codon{2,3,4}_fs3, host codon_indices)
// of the codons ending at a row whose nucleotide is x0, x1..x3 the
// three before it
struct Codons {
  int c2, c3, c4;
};

__device__ __forceinline__ Codons fs3_codons(int x0, int x1, int x2, int x3) {
  const int two = x0 * 84 + x1 * 21;
  Codons c;
  c.c2 = min(two, FS3_DEGEN_QC1);
  c.c3 = min(two + x2 * 5 + 1, FS3_DEGEN_C);
  c.c4 = min(two + x2 * 5 + x3 + 2, FS3_DEGEN_QC1);
  return c;
}

// ---------------------------------------------------------------------
// Copies from global to shared memory by the copy engine, completed on
// an mbarrier (Hopper: cp.async.bulk, mbarrier expect_tx/try_wait).
// ---------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
               : "memory");
}

// The producer's arrival, announcing <bytes> to come on the barrier.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The emission rows of one pass, FS3_RING - 1 rows ahead: a ring of
// FS3_RING slots of three codon rows [3][Mp] in shared memory, an
// mbarrier a slot.  Row n of the pass (its n-th row in the pass's
// order) lies in slot n % FS3_RING; the group's thread 0 fetches row
// n + FS3_RING - 1 while the group computes row n, into the slot row
// n - 1 held, which every thread of the group has read by then (the
// row's scan or reduction needs every thread's values).  The three rows are a model's codon rows min()-clamped into
// 0..337 (fs3_codons), so a fetch never reads past the table, also for
// rows whose codons the recurrence does not read.
struct Fs3Ring {
  const float* etab;    // the model's codon odds [338][Mp] (global)
  float* slots;         // [FS3_RING][3][Mp] (shared)
  unsigned bar;         // shared address of slot 0's mbarrier; slot s +8s
  int Mp;
  bool producer;        // the group's thread 0, or every thread (direct)

  __device__ __forceinline__ void fetch(int n, const Codons& c) const {
    const unsigned s = (unsigned)n % FS3_RING;
    const unsigned bytes = (unsigned)Mp * sizeof(float);
    const unsigned b = bar + 8 * s;
    const unsigned dst = smem_addr(slots + 3 * s * Mp);
    // the slot's earlier reads come before the engine's writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_expect(b, 3 * bytes);
    bulk_copy(dst, etab + (size_t)c.c2 * Mp, bytes, b);
    bulk_copy(dst + bytes, etab + (size_t)c.c3 * Mp, bytes, b);
    bulk_copy(dst + 2 * bytes, etab + (size_t)c.c4 * Mp, bytes, b);
  }

  // Waits for row n; the thread's lanes k0.. of its E2 row (E3, E4 at
  // +Mp, +2Mp).
  __device__ __forceinline__ const float* rows(int n, int k0) const {
    const unsigned s = (unsigned)n % FS3_RING;
    mbar_wait(bar + 8 * s, ((unsigned)n / FS3_RING) & 1);
    return slots + 3 * s * Mp + k0;
  }

  // The thread's lanes k0.. of the E2, E3 and E4 rows of the row whose
  // codons are <c>: from the ring (row n) or, DIRECT, from etab.
  template <bool DIRECT>
  __device__ __forceinline__ void rows3(int n, const Codons& c, int k0,
                                        const float*& e2, const float*& e3,
                                        const float*& e4) const {
    if (DIRECT) {
      e2 = etab + (size_t)c.c2 * Mp + k0;
      e3 = etab + (size_t)c.c3 * Mp + k0;
      e4 = etab + (size_t)c.c4 * Mp + k0;
    } else {
      e2 = rows(n, k0);
      e3 = e2 + Mp;
      e4 = e2 + 2 * Mp;
    }
  }
};

// The direct loads keep one row's codons ahead, as the ring does.
static_assert(FS3_RING == 2, "Fs3Forward::qn holds one row ahead");

template <int P, bool STORE, bool DIRECT>
struct Fs3Forward {
  const Group& g;
  const Fs3Ring& ring;              // the codon rows, a row ahead
  const float* ttab;                // [NTR][Mp] transitions
  int Mp, k0;
  float pmove, ploop, emove, eloop;
  double* spec;                     // STORE: 6 rows of stride ld
  int ld;
  // per-row factors of rows i-1, i-2, i-3 into the current frame
  float f1, f2, f3;
  // specials of rows i-1..i-3, unscaled (xB only i-1, i-2)
  float b1, b2, n1, n2, n3, j1, j2, j3, c1, c2, c3;
  // the producer: nucleotides x(r-1) (read a fetch early) and x(r-2..r-4)
  // of the next row r it fetches; direct: that row's codons
  int nx, h1, h2, h3;
  Codons qn;
  double lacc, score;

  __device__ __forceinline__ float tr(int r, int j) const {
    return ttab[r * Mp + k0 + j];
  }

  // The producer fetches row r (the ring's row r - 2) and steps its
  // nucleotides on to row r + 1.
  __device__ __forceinline__ void fetch(int r, int len, const int8_t* seq) {
    const Codons c = fs3_codons(nx, h1, h2, h3);
    if (DIRECT)
      qn = c;
    else
      ring.fetch(r - 2, c);
    h3 = h2;
    h2 = h1;
    h1 = nx;
    nx = r < len ? fs3_nt(seq[r]) : FS3_PLACE;
  }

  // Row i.  qa = Q(i-1), qb = Q(i-2) -> Q(i); na = N(i-1), nb = N(i-2),
  // nc = N(i-3) -> N(i); va = sv(i-1), vb = sv(i-2) -> sv(i).
  __device__ __forceinline__ void step(int i, int len, const int8_t* seq,
                                       float (&qa)[P], float (&qb)[P],
                                       float (&na)[P], float (&nb)[P],
                                       float (&nc)[P], float (&va)[P],
                                       float (&vb)[P]) {
    const Codons cur = qn;
    if (ring.producer && i + FS3_RING - 1 <= len)
      fetch(i + FS3_RING - 1, len, seq);
    const float *e2, *e3, *e4;
    ring.rows3<DIRECT>(i - 2, cur, k0, e2, e3, e4);
    const bool ge3 = i >= 3;
    float msv[P];
    float sumsv = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float sv = f2 * (b2 * tr(P_BM, j) + qb[j]);
      float m = sv * e2[j];
      if (ge3) m += f1 * va[j] * e3[j] + f2 * vb[j] * e4[j];
      msv[j] = m;
      vb[j] = sv;
      sumsv += m;
    }
    // this run's D chain as a map of its carry D[k0] (dp_common.cuh)
    float coef = 1.f, val = 0.f, sc = 1.f, se = 0.f;
#pragma unroll
    for (int j = 1; j < P; ++j) {
      const float tdd = tr(P_DD, j);
      val = tr(P_MD, j) * msv[j - 1] + tdd * val;
      coef *= tdd;
      sc += coef;
      se += val;
    }
    const float tddn = trv(ttab, Mp, P_DD, k0 + P);
    const float tmdn = trv(ttab, Mp, P_MD, k0 + P);
    Aff loc{tddn * coef, tmdn * msv[P - 1] + tddn * val, sc, se + sumsv};
    Aff ex, tot;
    group_scan<false>(g, loc, ex, tot);
    const float xE = tot.e;
    float d[P];
    d[0] = ex.b;
#pragma unroll
    for (int j = 1; j < P; ++j)
      d[j] = tr(P_MD, j) * msv[j - 1] + tr(P_DD, j) * d[j - 1];
    // Q(i) reads lane k-1 of M(i), I(i) = f3 N(i-3), D(i)
    float mp, ip, dp;
    lane_before(g, msv[P - 1], f3 * nc[P - 1], d[P - 1], mp, ip, dp);
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const float mm = j ? msv[j - 1] : mp;
      const float ii = j ? f3 * nc[j - 1] : ip;
      const float dd = j ? d[j - 1] : dp;
      qb[j] = mm * tr(P_MM, j) + ii * tr(P_IM, j) + dd * tr(P_DM, j);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      nc[j] = msv[j] * tr(P_MI, j) + f3 * nc[j] * tr(P_II, j);
    // specials; before row 3 the N/J/C rows read are the initial ones
    const float xN = ge3 ? f3 * n3 * ploop : 1.f;
    const float xJ = (ge3 ? f3 * j3 * ploop : 0.f) + xE * eloop;
    const float xC = (ge3 ? f3 * c3 * ploop : 0.f) + xE * emove;
    const float xB = (xN + xJ) * pmove;
    const float s = STORE ? (xE > 1.0e4f ? xE : 1.f) : fmaxf(xE, 1.f);
    const float sinv = 1.f / s;
    lacc += (double)logf(s);
    if (i == len)
      score = lacc + (double)logf(sinv * (xC + (f1 * c1 + f2 * c2) * ploop) *
                                  pmove);
    if (STORE && g.t == 0) {
      double* r = spec + i;
      r[0] = xB * sinv;
      r[ld] = xN * sinv;
      r[2 * ld] = xJ * sinv;
      r[3 * ld] = xC * sinv;
      r[4 * ld] = xE * sinv;
      r[5 * ld] = lacc;
    }
    f3 = f2 * sinv;
    f2 = f1 * sinv;
    f1 = sinv;
    b2 = b1;
    b1 = xB;
    n3 = n2;
    n2 = n1;
    n1 = xN;
    j3 = j2;
    j2 = j1;
    j1 = xJ;
    c3 = c2;
    c2 = c1;
    c1 = xC;
  }
};

// The fs3 Forward over rows 2..len of one window.  STORE (decoding)
// rescales sparsely (xE > 1e4, the host parser's cadence) and writes
// the six specials of rows 0..len to `spec`: xB, xN, xJ, xC, xE after
// the row's rescale and the log scale through the row.  The gate
// rescales every row by max(xE, 1).  Returns the score in nats (-inf
// for len < 2) and the total log scale in `lsf`, both summed in
// double.  Every thread of the group returns after the same rows, and
// every row fetched into <ring> has been waited for.
template <int P, bool STORE, bool DIRECT>
__device__ double fs3_forward_pass(const Group& g, const Fs3Ring& ring,
                                   const float* ttab, int Mp,
                                   const int8_t* __restrict__ seq, int len,
                                   float pmove, float nj, double* spec,
                                   int ld, double& lsf) {
  Fs3Forward<P, STORE, DIRECT> w{g, ring, ttab, Mp, g.t * P};
  w.pmove = pmove;
  w.ploop = 1.f - pmove;
  w.emove = nj > 0.f ? 0.5f : 1.f;
  w.eloop = nj > 0.f ? 0.5f : 0.f;
  w.spec = spec;
  w.ld = ld;
  w.f1 = w.f2 = w.f3 = 1.f;
  // rows 1 and 0: N = 1, B = pmove
  w.b1 = w.b2 = pmove;
  w.n1 = w.n2 = 1.f;
  w.n3 = w.j1 = w.j2 = w.j3 = w.c1 = w.c2 = w.c3 = 0.f;
  // row 2's codons end at x(1) after x(0); rows before 0 are FS3_PLACE
  w.nx = len >= 2 ? fs3_nt(seq[1]) : FS3_PLACE;
  w.h1 = len >= 1 ? fs3_nt(seq[0]) : FS3_PLACE;
  w.h2 = w.h3 = FS3_PLACE;
  w.qn = Codons{0, 0, 0};
  if (ring.producer)
    for (int r = 2; r <= len && r < 1 + FS3_RING; ++r) w.fetch(r, len, seq);
  w.lacc = 0.0;
  w.score = -INFINITY;
  if (STORE && g.t == 0) {
    for (int r = 0; r < 2; ++r) {
      spec[r] = pmove;
      spec[ld + r] = 1.0;
      spec[2 * ld + r] = spec[3 * ld + r] = spec[4 * ld + r] = 0.0;
      spec[5 * ld + r] = 0.0;
    }
  }
  float qa[P], qb[P], na[P], nb[P], nc[P], va[P], vb[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    qa[j] = qb[j] = na[j] = nb[j] = nc[j] = va[j] = vb[j] = 0.f;
  for (int i = 2; i <= len; i += 6) {
    w.step(i, len, seq, qa, qb, na, nb, nc, va, vb);
    if (i + 1 > len) break;
    w.step(i + 1, len, seq, qb, qa, nc, na, nb, vb, va);
    if (i + 2 > len) break;
    w.step(i + 2, len, seq, qa, qb, nb, nc, na, va, vb);
    if (i + 3 > len) break;
    w.step(i + 3, len, seq, qb, qa, na, nb, nc, vb, va);
    if (i + 4 > len) break;
    w.step(i + 4, len, seq, qa, qb, nc, na, nb, va, vb);
    if (i + 5 > len) break;
    w.step(i + 5, len, seq, qb, qa, nb, nc, na, vb, va);
  }
  lsf = w.lacc;
  return w.score;
}

// fs3_forward_pass for a segmented group (the direct loads): each row
// in S segments of 32 W P lanes.  The rings' rows wait in <slot>, seven
// rows of a segment (rows v of segment s, lane j of thread t at ((7 s +
// v) P + j) 32 W + t): Q(r) in row r % 2, sv(r) in row 2 + r % 2, N(r)
// in row 4 + r % 3, zero before the window; a row reads Q(i-2), sv(i-1),
// sv(i-2) and N(i-3) and writes Q(i), sv(i) and N(i) in their places.
// The rows are stored unscaled, as the registers hold them.  The D chain
// enters a segment at the carry the last one's scan total gives, and
// Q(i) takes the previous segment's last lane of M(i), I(i) and D(i)
// through <cx>; xE sums the segments' totals.
template <int P, bool STORE>
__device__ double fs3_forward_pass_seg(const Group& g, const Fs3Ring& ring,
                                       const float* ttab, int Mp, int S,
                                       const int8_t* __restrict__ seq,
                                       int len, float pmove, float nj,
                                       double* spec, int ld, double& lsf,
                                       float* slot, float* cx) {
  const int NT = 32 * g.W, SEG = NT * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  float f1 = 1.f, f2 = 1.f, f3 = 1.f;
  float b1 = pmove, b2 = pmove, n1 = 1.f, n2 = 1.f, n3 = 0.f;
  float j1 = 0.f, j2 = 0.f, j3 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
  // the nucleotides of the next row whose codons are taken: x(r-1) and
  // x(r-2..r-4); row 2's codons end at x(1) after x(0)
  int nx = len >= 2 ? fs3_nt(seq[1]) : FS3_PLACE;
  int h1 = len >= 1 ? fs3_nt(seq[0]) : FS3_PLACE;
  int h2 = FS3_PLACE, h3 = FS3_PLACE;
  double lacc = 0.0, score = -INFINITY;
  if (STORE && g.t == 0) {
    for (int r = 0; r < 2; ++r) {
      spec[r] = pmove;
      spec[ld + r] = 1.0;
      spec[2 * ld + r] = spec[3 * ld + r] = spec[4 * ld + r] = 0.0;
      spec[5 * ld + r] = 0.0;
    }
  }
  for (size_t q = g.t; q < (size_t)7 * S * SEG; q += NT) slot[q] = 0.f;
  for (int i = 2; i <= len; ++i) {
    const Codons cur = fs3_codons(nx, h1, h2, h3);
    h3 = h2;
    h2 = h1;
    h1 = nx;
    nx = i < len ? fs3_nt(seq[i]) : FS3_PLACE;
    const bool ge3 = i >= 3;
    const int vq = i & 1, va_ = 2 + ((i - 1) & 1), vb_ = 2 + (i & 1),
              vn = 4 + i % 3;
    float xE = 0.f, dcarry = 0.f;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 7 * SEG + g.t;
      float qb[P], va[P], vb[P], nc[P], msv[P], d[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        qb[j] = st[vq * SEG + j * NT];
        va[j] = st[va_ * SEG + j * NT];
        vb[j] = st[vb_ * SEG + j * NT];
        nc[j] = st[vn * SEG + j * NT];
      }
      const float *e2, *e3, *e4;
      ring.rows3<true>(0, cur, k0, e2, e3, e4);
      float sumsv = 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float sv = f2 * (b2 * ttab[P_BM * Mp + k0 + j] + qb[j]);
        float m = sv * e2[j];
        if (ge3) m += f1 * va[j] * e3[j] + f2 * vb[j] * e4[j];
        msv[j] = m;
        vb[j] = sv;
        sumsv += m;
      }
      float coef = 1.f, val = 0.f, sc = 1.f, se = 0.f;
#pragma unroll
      for (int j = 1; j < P; ++j) {
        const float tdd = ttab[P_DD * Mp + k0 + j];
        val = ttab[P_MD * Mp + k0 + j] * msv[j - 1] + tdd * val;
        coef *= tdd;
        sc += coef;
        se += val;
      }
      const float tddn = trv(ttab, Mp, P_DD, k0 + P);
      const float tmdn = trv(ttab, Mp, P_MD, k0 + P);
      Aff loc{tddn * coef, tmdn * msv[P - 1] + tddn * val, sc, se + sumsv};
      Aff ex, tot;
      group_scan<false>(g, loc, ex, tot);
      d[0] = fmaf(ex.a, dcarry, ex.b);
#pragma unroll
      for (int j = 1; j < P; ++j)
        d[j] = ttab[P_MD * Mp + k0 + j] * msv[j - 1] +
               ttab[P_DD * Mp + k0 + j] * d[j - 1];
      xE += fmaf(tot.c, dcarry, tot.e);
      dcarry = fmaf(tot.a, dcarry, tot.b);
      // Q(i) reads lane k-1 of M(i), I(i) = f3 N(i-3), D(i)
      float mp, ip, dp;
      lane_before_seg(g, msv[P - 1], f3 * nc[P - 1], d[P - 1], s, cx, mp, ip,
                      dp);
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const float mm = j ? msv[j - 1] : mp;
        const float ii = j ? f3 * nc[j - 1] : ip;
        const float dd = j ? d[j - 1] : dp;
        qb[j] = mm * ttab[P_MM * Mp + k0 + j] + ii * ttab[P_IM * Mp + k0 + j] +
                dd * ttab[P_DM * Mp + k0 + j];
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        nc[j] = msv[j] * ttab[P_MI * Mp + k0 + j] +
                f3 * nc[j] * ttab[P_II * Mp + k0 + j];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        st[vq * SEG + j * NT] = qb[j];
        st[vb_ * SEG + j * NT] = vb[j];
        st[vn * SEG + j * NT] = nc[j];
      }
    }
    // specials; before row 3 the N/J/C rows read are the initial ones
    const float xN = ge3 ? f3 * n3 * ploop : 1.f;
    const float xJ = (ge3 ? f3 * j3 * ploop : 0.f) + xE * eloop;
    const float xC = (ge3 ? f3 * c3 * ploop : 0.f) + xE * emove;
    const float xB = (xN + xJ) * pmove;
    const float sc = STORE ? (xE > 1.0e4f ? xE : 1.f) : fmaxf(xE, 1.f);
    const float sinv = 1.f / sc;
    lacc += (double)logf(sc);
    if (i == len)
      score = lacc + (double)logf(sinv * (xC + (f1 * c1 + f2 * c2) * ploop) *
                                  pmove);
    if (STORE && g.t == 0) {
      double* r = spec + i;
      r[0] = xB * sinv;
      r[ld] = xN * sinv;
      r[2 * ld] = xJ * sinv;
      r[3 * ld] = xC * sinv;
      r[4 * ld] = xE * sinv;
      r[5 * ld] = lacc;
    }
    f3 = f2 * sinv;
    f2 = f1 * sinv;
    f1 = sinv;
    b2 = b1;
    b1 = xB;
    n3 = n2;
    n2 = n1;
    n1 = xN;
    j3 = j2;
    j2 = j1;
    j1 = xJ;
    c3 = c2;
    c2 = c1;
    c1 = xC;
  }
  lsf = lacc;
  return score;
}

// ---------------------------------------------------------------------
// The launch plan (plan.cuh; ops/multimodel.py fs3_plan).  A class row
// holds the addresses of the class's stacked tables etab [g][338][Mp]
// and ttab [g][8][Mp], P, W, Mp and G, whether its groups take the
// direct loads (word 6), whether its transitions stay in global memory
// (word 7), the segments S and a segmented class's scratch (words 8,
// 9); the items are window rows b (the gate) or 2b + pass (decoding:
// pass 0 the Forward, 1 the Backward).  Each block stages its model's
// transitions in shared memory once, unless word 7 says not.
// ---------------------------------------------------------------------
constexpr int FS3_ROWS = 338;       // packed codon rows of a model

__host__ __device__ constexpr size_t fs3_table_bytes(int Mp) {
  return (size_t)NTR * Mp * sizeof(float);
}

// Shared bytes of one group past the block's transitions, 128-byte
// aligned: its emission ring (FS3_RING slots of three Mp-float rows),
// the slots' mbarriers (16-byte aligned) and the W > 1 exchange scratch
// (Exch); with the direct loads, the scratch alone.
__host__ __device__ constexpr size_t fs3_bars_bytes() {
  return (8 * FS3_RING + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t fs3_group_bytes(int Mp, int W,
                                                    bool direct = false) {
  return ((direct ? 0
                  : (size_t)3 * FS3_RING * Mp * sizeof(float) +
                        fs3_bars_bytes()) +
          (size_t)W * (sizeof(Aff) + 4 * sizeof(float)) + 127) / 128 * 128;
}

// What a group computes: its window b (< 0: none), its pass, the model;
// a segmented group's segments, slot of the scratch (its index sid, of
// the scratch of class row cls) and carries.
struct Fs3Slot {
  Fs3Ring ring;         // the model's codon odds, fetched a row ahead
  const float* ttab;    // its transitions [8][Mp] (shared)
  int P, M, Mp;
  int b, pass;
  Group g;
  int S;
  float* slot;
  int sid;
  const long long* cls;
  float* cx;
};

// Floats a model lane of a segmented group keeps in its slot: the
// Forward's seven ring rows, the Backward's eight (fs3_domdec.cu); a
// decoding item's slot takes the larger.
constexpr int FS3_SEG_ROWS_GATE = 7, FS3_SEG_ROWS_DECODING = 8;

// Bytes of a segmented group's slot (plan.cuh) of a class of Mp padded
// lanes; <per>: items a window (1 the gate, 2 decoding).
__host__ __device__ constexpr size_t fs3_seg_slot_bytes(int per, int Mp) {
  return (size_t)(per == 2 ? FS3_SEG_ROWS_DECODING : FS3_SEG_ROWS_GATE) *
         Mp * sizeof(float);
}

// Every thread of the block calls it: reads the block's row of the plan,
// stages the model's transitions in shared memory, carves the groups'
// rings and scratch, sets up the rings' mbarriers and syncs the block;
// after it no barrier spans the block, so a group without a window may
// return.  <per>: items a window (1 the gate, 2 decoding).  MODE, the
// launch's (fs3_mode): 0 the ring, 1 the direct loads, 2 and 3 the
// direct loads with the transitions of a class whose word 7 says so
// left in global memory; below 2 they are staged and read as shared
// memory; 4 those of 2 and the segmented walk (blocks of the segmented
// group's 16 warps), whose segmented block takes a slot of its class's
// scratch (plan.cuh seg_take) and frees it at its end (seg_free).
template <int MODE>
__device__ __forceinline__ Fs3Slot fs3_slot(const long long* __restrict__ plan,
                                            int ncls, int nblk, int per,
                                            char* smem) {
  constexpr bool direct = MODE >= 1;
  const long long* bk = plan + PLAN_CLS * ncls + PLAN_BLK * (long long)blockIdx.x;
  const long long* c = plan + PLAN_CLS * bk[0];
  Fs3Slot s;
  s.P = (int)c[2];
  const int W = (int)c[3];
  s.Mp = (int)c[4];
  const int G = (int)c[5];
  const int model = (int)bk[1];
  s.M = (int)bk[2];
  const int first = (int)bk[3], count = (int)bk[4];
  s.ring.etab = reinterpret_cast<const float*>(c[0]) +
                (size_t)model * FS3_ROWS * s.Mp;
  s.ring.Mp = s.Mp;
  const bool tglobal = MODE >= 2 && c[7] != 0;
  const float* tg = reinterpret_cast<const float*>(c[1]) +
                    (size_t)model * NTR * s.Mp;
  s.ttab = tg;
  if (!tglobal) {
    float* tt = reinterpret_cast<float*>(smem);
    for (int q = threadIdx.x; q < NTR * s.Mp; q += blockDim.x) tt[q] = tg[q];
    s.ttab = tt;
  }
  const int gi = (threadIdx.x >> 5) / W;
  Group& g = s.g;
  g.W = W;
  g.warp = (threadIdx.x >> 5) % W;
  g.lane = threadIdx.x & 31;
  g.t = g.warp * 32 + g.lane;
  g.bar = 1 + gi;
  float* ring = reinterpret_cast<float*>(
      smem + (tglobal ? 0 : fs3_table_bytes(s.Mp)) +
      (size_t)gi * fs3_group_bytes(s.Mp, W, direct));
  s.ring.slots = ring;
  s.ring.bar = smem_addr(ring + 3 * FS3_RING * s.Mp);
  s.ring.producer = direct || g.t == 0;
  float* x = direct ? ring
                    : ring + 3 * FS3_RING * s.Mp +
                          fs3_bars_bytes() / sizeof(float);
  g.x.agg = reinterpret_cast<Aff*>(x);
  g.x.bnd = x + 4 * W;
  g.x.red = x + 7 * W;
  s.S = MODE >= 4 ? (int)c[8] : 1;
  s.slot = nullptr;
  s.sid = 0;
  s.cls = c;
  s.cx = x + 8 * W;
  s.b = -1;
  s.pass = 0;
  if (gi < G && gi < count) {
    const int item = (int)plan[PLAN_CLS * ncls + PLAN_BLK * nblk + first + gi];
    s.b = item / per;
    s.pass = item % per;
    if (g.t == 0 && !direct) {
      for (int q = 0; q < FS3_RING; ++q) mbar_init(s.ring.bar + 8 * q);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  __syncthreads();
  if (MODE >= 4 && s.S > 1)
    s.slot = reinterpret_cast<float*>(
        seg_take(c, fs3_seg_slot_bytes(per, s.Mp),
                 reinterpret_cast<int*>(s.cx), s.sid));
  return s;
}

}  // namespace bt

// Calls F<P>(args...) for the block's P (the plan's classes are checked
// on the host, fs3_check).
#define BT_FS3_DISPATCH(P, CALL)   \
  switch (P) {                     \
    case 3: CALL(3); break;        \
    case 5: CALL(5); break;        \
    case 9: CALL(9); break;        \
    case 13: CALL(13); break;      \
  }

// The kernel instance of a plan of blocks of <warps> warps (the host
// copy of the table): 0 for the ring, 1 for the direct loads (the plan
// gives every class word 6 when one has it), 2 when a class also leaves
// its transitions in global memory or a block takes more than eight
// warps, 3 past sixteen; with a segmented class 4 (blocks of its group's
// 16 warps; the plan segments any class of more beside it).  Instances
// 0 and 1 take up to 255 registers a thread, so eight warps a block; the
// others cap their registers (fs3_threads), so that a block of up to 16
// or 32 warps launches.
__host__ __device__ constexpr int fs3_threads(int mode) {
  return mode == 3 ? 1024 : mode == 2 || mode == 4 ? 512 : 256;
}

static inline int fs3_mode(const long long* plan, int ncls, int warps) {
  bool direct = false, tglobal = false, seg = false;
  for (int i = 0; i < ncls; ++i) {
    direct = direct || plan[PLAN_CLS * i + 6] != 0;
    tglobal = tglobal || plan[PLAN_CLS * i + 7] != 0;
    seg = seg || plan[PLAN_CLS * i + 8] > 1;
  }
  return seg ? 4
             : warps > 16 ? 3 : warps > 8 || tglobal ? 2 : direct ? 1 : 0;
}

// Host side: checks a plan's classes (the host copy of the table) and
// gives the launch's dynamic shared memory: the largest class's
// transitions and groups.  Returns 0, or a cudaError_t.
static inline int fs3_check(const long long* plan, int ncls, int warps,
                            size_t& smem) {
  const int cap = plan_smem_optin();
  if (ncls <= 0 || warps <= 0 || warps > 32) return cudaErrorInvalidValue;
  smem = 0;
  for (int i = 0; i < ncls; ++i) {
    const long long* c = plan + PLAN_CLS * i;
    const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], G = (int)c[5];
    const int S = (int)c[8];
    if (!(P == 3 || P == 5 || P == 9 || P == 13) || W < 1 || S < 1 ||
        Mp != 32 * P * W * S || G < 1 || G * W > warps ||
        (W > 1 && G > 15) ||
        (S > 1 && (W < 2 || G != 1 || c[9] == 0 || !c[6] || !c[7] ||
                   warps > 16)))
      return cudaErrorInvalidValue;
    const size_t need = (c[7] ? 0 : bt::fs3_table_bytes(Mp)) +
                        (size_t)G * bt::fs3_group_bytes(Mp, W, c[6] != 0) +
                        (S > 1 ? bt::SEG_CARRY * sizeof(float) : 0);
    smem = need > smem ? need : smem;
  }
  return smem <= (size_t)cap ? 0 : cudaErrorInvalidValue;
}
