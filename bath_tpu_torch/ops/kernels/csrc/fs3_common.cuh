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
// M = 400) does not fit in shared memory; each row's three codon rows
// are read through L1/L2 (a thread's P lanes are consecutive floats).

#pragma once

#include "dp_common.cuh"

namespace bt {

constexpr int FS3_PLACE = 338;      // nucleotide >= 4 or before the window
constexpr int FS3_DEGEN_C = 336;
constexpr int FS3_DEGEN_QC1 = 337;

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

template <int P, bool STORE>
struct Fs3Forward {
  const Group& g;
  const float* __restrict__ etab;   // [338][Mp] codon odds (global)
  const float* ttab;                // [NTR][Mp] transitions
  int Mp, k0;
  float pmove, ploop, emove, eloop;
  double* spec;                     // STORE: 6 rows of stride ld
  int ld;
  // per-row factors of rows i-1, i-2, i-3 into the current frame
  float f1, f2, f3;
  // specials of rows i-1..i-3, unscaled (xB only i-1, i-2)
  float b1, b2, n1, n2, n3, j1, j2, j3, c1, c2, c3;
  int h1, h2, h3;                   // nucleotides of rows i-1..i-3
  double lacc, score;

  __device__ __forceinline__ float tr(int r, int j) const {
    return ttab[r * Mp + k0 + j];
  }

  // Row i.  qa = Q(i-1), qb = Q(i-2) -> Q(i); na = N(i-1), nb = N(i-2),
  // nc = N(i-3) -> N(i); va = sv(i-1), vb = sv(i-2) -> sv(i).
  __device__ __forceinline__ void step(int i, int len, const int8_t* seq,
                                       float (&qa)[P], float (&qb)[P],
                                       float (&na)[P], float (&nb)[P],
                                       float (&nc)[P], float (&va)[P],
                                       float (&vb)[P]) {
    const int x0 = fs3_nt(seq[i - 1]);
    const Codons cd = fs3_codons(x0, h1, h2, h3);
    const float* e2 = etab + (size_t)cd.c2 * Mp + k0;
    const float* e3 = etab + (size_t)cd.c3 * Mp + k0;
    const float* e4 = etab + (size_t)cd.c4 * Mp + k0;
    const bool ge3 = i >= 3;
    float msv[P];
    float sumsv = 0.f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float sv = f2 * (b2 * tr(P_BM, j) + qb[j]);
      float m = sv * __ldg(e2 + j);
      if (ge3) m += f1 * va[j] * __ldg(e3 + j) + f2 * vb[j] * __ldg(e4 + j);
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
    h3 = h2;
    h2 = h1;
    h1 = x0;
  }
};

// The fs3 Forward over rows 2..len of one window.  STORE (decoding)
// rescales sparsely (xE > 1e4, the host parser's cadence) and writes
// the six specials of rows 0..len to `spec`: xB, xN, xJ, xC, xE after
// the row's rescale and the log scale through the row.  The gate
// rescales every row by max(xE, 1).  Returns the score in nats (-inf
// for len < 2) and the total log scale in `lsf`, both summed in
// double.  Every thread of the group returns after the same rows.
template <int P, bool STORE>
__device__ double fs3_forward_pass(const Group& g, const float* etab,
                                   const float* ttab, int Mp,
                                   const int8_t* __restrict__ seq, int len,
                                   float pmove, float nj, double* spec,
                                   int ld, double& lsf) {
  Fs3Forward<P, STORE> w{g, etab, ttab, Mp, g.t * P};
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
  w.h1 = len >= 1 ? fs3_nt(seq[0]) : FS3_PLACE;
  w.h2 = w.h3 = FS3_PLACE;
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

}  // namespace bt

// Host side: the launch shape of the fs3 kernels.  Four windows to a
// block for W = 1 (the rings take ~10P registers a thread, so smaller
// blocks pack an SM more fully); one window to a block for W > 1.  The
// transition table goes to shared memory, ahead of the W > 1 exchange
// scratch.
static inline BtLaunch fs3_plan(int B, int Mp, int P) {
  BtLaunch l;
  l.W = Mp / (32 * P);
  l.G = l.W == 1 ? 4 : 1;
  l.threads = 32 * l.W * l.G;
  l.blocks = (B + l.G - 1) / l.G;
  l.tab_in_smem = true;
  l.smem = (size_t)bt::NTR * Mp * sizeof(float) +
           (size_t)l.W * (sizeof(bt::Aff) + 4 * sizeof(float));
  return l;
}

#define BT_DISPATCH_FS3_P(P, CALL)         \
  switch (P) {                             \
    case 3: CALL(3); break;                \
    case 5: CALL(5); break;                \
    case 9: CALL(9); break;                \
    case 13: CALL(13); break;              \
    default: return cudaErrorInvalidValue; \
  }
