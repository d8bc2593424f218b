// fs3 Forward and Backward parsers for frameshift domain decoding of
// the DNA windows that pass the fs3 gate and arbitration.
//
// Replaces bath_tpu/ops/jaxk/kernels.py _fs3_domdec_impl (the jnp
// kernel that the TPU runs for p7_BackwardParser_Frameshift_3Codons +
// p7_DomainDecoding_Frameshift) and bath_tpu/ops/jaxk/multimodel.py
// fs3_domdec_pack_batch (build_fs3_domdec_pack: window b under model
// slot[b]; the TPU's lane packing is not carried over).  Per window: the
// fs3 Forward of fs3_common.cuh with the host's sparse rescale cadence,
// storing the six specials of every nucleotide row in f64, and the
// Backward parser, storing its six specials per row the same way.  The
// stride-3 combine into btot/etot/mocc, its exp(logw - logZ) weights and
// the cumsums run as tensor ops after the kernel (ops/fs3_domdec.py
// finish), shared with the plain version; the per-window dec_loop
// enters only there.
//
// Backward row i (the mirror of the Forward, ref fwdback_fs.c :565):
//   ivxb[k] = M(i+2)[k] E2(i+2) + M(i+3)[k] E3(i+3) + M(i+4)[k] E4(i+4)
//   xB = sum_k ivxb tBM;  N/J/C from row i+3;  xE = xC emove + xJ eloop
//   I(i)[k] = ivxb[k+1] tIM[k+1] + I(i+3)[k] tII[k]
//   D(i)[k] = ivxb[k+1] tDM[k+1] + xE + tDD[k+1] D(i)[k+1]   (suffix scan)
//   M(i)[k] = ivxb[k+1] tMM[k+1] + I(i+3)[k] tMI[k] + xE + tMD[k+1] D(i)[k+1]
// with rows past the window zero.  Rescaling (xB outside [1e-4, 1e4])
// is rare, so a rescale multiplies the rings in place.
//
// What bounds it on the H100: like the gate, a latency chain of
// dependent rows, each with a group-wide reduction (xB) or scan, and
// three codon rows of odds a row, fetched a row ahead into shared memory
// (Fs3Ring in fs3_common.cuh; the Backward's codons end at rows i+2..i+4,
// so its producer walks the window down).  The two passes
// share no data (each writes its own specials), so a window takes two
// groups of the same block, one a pass, which run at the same time: the
// chain is L + 1 rows, not 2L + 1.  One launch takes every padded width
// of a batch, blocks longest window first (the plan of fs3_common.cuh).
// The backward keeps 7P ring floats a thread (M of four rows, I of
// three) and rotates them by copies.  A model past 32 warps of 13 lanes
// takes a group of 16 warps that walks each row in segments
// (fs3_common.cuh fs3_forward_pass_seg, fs3_backward_pass_seg), in an
// instance of its own (MODE 4).
//
// The instances of MODE 2-4 are compiled in a translation unit of their
// own, fs3_domdec_wide.cu, which includes this file with
// BT_FS3_DOMDEC_WIDE defined, so that the two halves compile at once
// (one nvcc a source).

#include "fs3_common.cuh"

namespace bt {

// The Backward's producer: the nucleotides x(r) .. x(r+3) of the next
// row r it fetches (FS3_PLACE past the window: the recurrence never
// reads those codons) and x(r-1), read a fetch early.  It walks the
// window down; row r is the ring's row len - r.
template <bool DIRECT>
struct Fs3BackFetch {
  const Fs3Ring& ring;
  const int8_t* seq;
  int len;
  int y1, y2, y3, y4, ny;
  Codons qn;            // direct loads: the next row's codons

  __device__ __forceinline__ void fetch(int r) {
    const Codons c{fs3_codons(y2, y1, 0, 0).c2, fs3_codons(y3, y2, y1, 0).c3,
                   fs3_codons(y4, y3, y2, y1).c4};
    if (DIRECT)
      qn = c;
    else
      ring.fetch(len - r, c);
    y4 = y3;
    y3 = y2;
    y2 = y1;
    y1 = ny;
    ny = r >= 2 ? fs3_nt(seq[r - 2]) : FS3_PLACE;
  }
};

template <int P, bool DIRECT>
__device__ void fs3_backward_pass(const Group& g, const Fs3Ring& ring,
                                  const float* ttab, int M, int Mp,
                                  const int8_t* __restrict__ seq, int len,
                                  float pmove, float nj, double* spec,
                                  int ld) {
  const int k0 = g.t * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  // M rows i+1..i+4, I rows i+1..i+3
  float m1[P], m2[P], m3[P], m4[P], i1[P], i2[P], i3[P];
#pragma unroll
  for (int j = 0; j < P; ++j)
    m1[j] = m2[j] = m3[j] = m4[j] = i1[j] = i2[j] = i3[j] = 0.f;
  // N/J/C of rows i+1..i+3
  float n1 = 0.f, n2 = 0.f, n3 = 0.f, jj1 = 0.f, jj2 = 0.f, jj3 = 0.f;
  float cc1 = 0.f, cc2 = 0.f, cc3 = 0.f;
  Fs3BackFetch<DIRECT> ahead{ring,
                     seq,
                     len,
                     FS3_PLACE,
                     FS3_PLACE,
                     FS3_PLACE,
                     FS3_PLACE,
                     len >= 1 ? fs3_nt(seq[len - 1]) : FS3_PLACE,
                     Codons{0, 0, 0}};
  if (ring.producer)
    for (int r = len; r >= 0 && r > len + 1 - FS3_RING; --r) ahead.fetch(r);
  double lsb = 0.0;
  for (int i = len; i >= 0; --i) {
    const Codons cur = ahead.qn;
    if (ring.producer && i >= FS3_RING - 1) ahead.fetch(i - FS3_RING + 1);
    float ivxb[P];
    float part = 0.f;
    {
      // the codon of c nt ending at row i+c, for i+c <= len
      const float *r2, *r3, *r4;
      ring.rows3<DIRECT>(len - i, cur, k0, r2, r3, r4);
      const float* e2 = i + 2 <= len ? r2 : nullptr;
      const float* e3 = i + 3 <= len ? r3 : nullptr;
      const float* e4 = i + 4 <= len ? r4 : nullptr;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float v = 0.f;
        if (e2) v += m2[j] * e2[j];
        if (e3) v += m3[j] * e3[j];
        if (e4) v += m4[j] * e4[j];
        ivxb[j] = v;
        part += ttab[P_BM * Mp + k0 + j] * v;
      }
    }
    part = warp_sum(part);
    // the next lane's ivxb (lane k0+P) for this run's last lane
    float nxt_iv = __shfl_down_sync(FULL, ivxb[0], 1);
    float xB = part;
    if (g.W > 1) {
      if (g.lane == 0) {
        g.x.red[g.warp] = part;
        g.x.bnd[3 * g.warp] = ivxb[0];
      }
      group_sync(g);
      xB = 0.f;
      for (int w = 0; w < g.W; ++w) xB += g.x.red[w];
      if (g.lane == 31) nxt_iv = g.warp + 1 < g.W ? g.x.bnd[3 * (g.warp + 1)] : 0.f;
    } else if (g.lane == 31) {
      nxt_iv = 0.f;
    }
    const float xC = i == len ? pmove : ploop * (i + 3 > len ? pmove : cc3);
    const float xJ = xB * pmove + ploop * jj3;
    const float xN = xB * pmove + ploop * n3;
    const float xE = xC * emove + xJ * eloop;
    // I(i) into i3's place once read; M before its D term into m4's
    // (M(i+4) is read); d = the D chain's input
    float d[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j;
      const float iv1 = j + 1 < P ? ivxb[j + 1] : nxt_iv;
      const bool real = k < M;
      const float ni = iv1 * trv(ttab, Mp, P_IM, k + 1) +
                       i3[j] * ttab[P_II * Mp + k];
      const float nm = iv1 * trv(ttab, Mp, P_MM, k + 1) +
                       i3[j] * ttab[P_MI * Mp + k];
      d[j] = real ? iv1 * trv(ttab, Mp, P_DM, k + 1) + xE : 0.f;
      m4[j] = real ? nm + xE : 0.f;
      i3[j] = ni;
    }
    // suffix D chain: D[k] = d[k] + tDD[k+1] D[k+1]
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
      m4[j] += nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
      nxt = d[j] + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
    }
    const float sb =
        (xB > 0.f && (xB > 1.0e4f || xB < 1.0e-4f)) ? xB : 1.f;
    const float sbi = 1.f / sb;
    lsb += (double)logf(sb);
    if (g.t == 0) {
      double* r = spec + i;
      r[0] = xB * sbi;
      r[ld] = xN * sbi;
      r[2 * ld] = i >= 3 ? xJ * sbi : 0.f;
      r[3 * ld] = i >= 3 ? xC * sbi : 0.f;
      r[4 * ld] = xE * sbi;
      r[5 * ld] = lsb;
    }
    // rotate: new rows (in m4, i3) become rows i+1 of the next step
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float nm = m4[j], ni = i3[j];
      m4[j] = m3[j];
      m3[j] = m2[j];
      m2[j] = m1[j];
      m1[j] = nm;
      i3[j] = i2[j];
      i2[j] = i1[j];
      i1[j] = ni;
    }
    n3 = n2;
    n2 = n1;
    n1 = xN;
    jj3 = jj2;
    jj2 = jj1;
    jj1 = xJ;
    cc3 = cc2;
    cc2 = cc1;
    cc1 = xC;
    if (sb != 1.f) {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        m1[j] *= sbi;
        m2[j] *= sbi;
        m3[j] *= sbi;
        m4[j] *= sbi;
        i1[j] *= sbi;
        i2[j] *= sbi;
        i3[j] *= sbi;
      }
      n1 *= sbi;
      n2 *= sbi;
      n3 *= sbi;
      jj1 *= sbi;
      jj2 *= sbi;
      jj3 *= sbi;
      cc1 *= sbi;
      cc2 *= sbi;
      cc3 *= sbi;
    }
  }
}

// fs3_backward_pass for a segmented group (the direct loads): each row
// in S segments of 32 W P lanes, in two walks.  The first (segments in
// order) forms ivxb from M(i+2..i+4) and the emissions, and the partial
// sums of xB; the second (segments from the last) takes xB's total,
// closes the suffix D chain (the carry entering each segment from the
// one after it) and writes M(i) and I(i).  The rings' rows wait in
// <slot>, eight rows of a segment (rows v of segment s, lane j of thread
// t at ((8 s + v) P + j) 32 W + t): M(r) in row r % 4, I(r) in row 4 +
// r % 3, ivxb in row 7, zero past the window; a rescale multiplies the
// rows the next rows read.  The last lane of a segment reads the next
// segment's first ivxb there.
template <int P>
__device__ void fs3_backward_pass_seg(const Group& g, const Fs3Ring& ring,
                                      const float* ttab, int M, int Mp, int S,
                                      const int8_t* __restrict__ seq, int len,
                                      float pmove, float nj, double* spec,
                                      int ld, float* slot) {
  const int NT = 32 * g.W, SEG = NT * P;
  const float ploop = 1.f - pmove;
  const float emove = nj > 0.f ? 0.5f : 1.f;
  const float eloop = nj > 0.f ? 0.5f : 0.f;
  float n1 = 0.f, n2 = 0.f, n3 = 0.f, jj1 = 0.f, jj2 = 0.f, jj3 = 0.f;
  float cc1 = 0.f, cc2 = 0.f, cc3 = 0.f;
  Fs3BackFetch<true> ahead{ring,
                           seq,
                           len,
                           FS3_PLACE,
                           FS3_PLACE,
                           FS3_PLACE,
                           FS3_PLACE,
                           len >= 1 ? fs3_nt(seq[len - 1]) : FS3_PLACE,
                           Codons{0, 0, 0}};
  ahead.fetch(len);
  for (size_t q = g.t; q < (size_t)8 * S * SEG; q += NT) slot[q] = 0.f;
  double lsb = 0.0;
  for (int i = len; i >= 0; --i) {
    const Codons cur = ahead.qn;
    if (i >= 1) ahead.fetch(i - 1);
    const int v2 = (i + 2) & 3, v3 = (i + 3) & 3, v4 = i & 3,
              vi = 4 + i % 3;
    float part = 0.f;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 8 * SEG + g.t;
      // the codon of c nt ending at row i+c, for i+c <= len
      const float *r2, *r3, *r4;
      ring.rows3<true>(0, cur, k0, r2, r3, r4);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float v = 0.f;
        if (i + 2 <= len) v += st[v2 * SEG + j * NT] * r2[j];
        if (i + 3 <= len) v += st[v3 * SEG + j * NT] * r3[j];
        if (i + 4 <= len) v += st[v4 * SEG + j * NT] * r4[j];
        part += ttab[P_BM * Mp + k0 + j] * v;
        st[7 * SEG + j * NT] = v;
      }
    }
    const float xB = group_sum(g, part);
    const float xC = i == len ? pmove : ploop * (i + 3 > len ? pmove : cc3);
    const float xJ = xB * pmove + ploop * jj3;
    const float xN = xB * pmove + ploop * n3;
    const float xE = xC * emove + xJ * eloop;
    const float sb =
        (xB > 0.f && (xB > 1.0e4f || xB < 1.0e-4f)) ? xB : 1.f;
    const float sbi = 1.f / sb;
    float carry = 0.f;
    for (int s = S - 1; s >= 0; --s) {
      const int k0 = s * SEG + g.t * P;
      float* st = slot + (size_t)s * 8 * SEG + g.t;
      float ivxb[P], i3[P], m4[P], d[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        ivxb[j] = st[7 * SEG + j * NT];
        i3[j] = st[vi * SEG + j * NT];
      }
      // the next lane's ivxb (lane k0+P) for this run's last lane
      float nxt_iv = __shfl_down_sync(FULL, ivxb[0], 1);
      if (g.lane == 0) g.x.bnd[3 * g.warp] = ivxb[0];
      group_sync(g);
      if (g.lane == 31)
        nxt_iv = g.warp + 1 < g.W ? g.x.bnd[3 * (g.warp + 1)]
                 : s + 1 < S      ? slot[(size_t)(8 * (s + 1) + 7) * SEG]
                                  : 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + j;
        const float iv1 = j + 1 < P ? ivxb[j + 1] : nxt_iv;
        const bool real = k < M;
        const float ni = iv1 * trv(ttab, Mp, P_IM, k + 1) +
                         i3[j] * ttab[P_II * Mp + k];
        const float nm = iv1 * trv(ttab, Mp, P_MM, k + 1) +
                         i3[j] * ttab[P_MI * Mp + k];
        d[j] = real ? iv1 * trv(ttab, Mp, P_DM, k + 1) + xE : 0.f;
        m4[j] = real ? nm + xE : 0.f;
        i3[j] = ni;
      }
      // suffix D chain: D[k] = d[k] + tDD[k+1] D[k+1]
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
        m4[j] += nxt * trv(ttab, Mp, P_MD, k0 + j + 1);
        nxt = d[j] + trv(ttab, Mp, P_DD, k0 + j + 1) * nxt;
      }
      carry = fmaf(tot.a, carry, tot.b);
      if (sb != 1.f) {
        // M(i+1..i+3) and I(i+1), I(i+2), the rows the next rows read
#pragma unroll
        for (int j = 0; j < P; ++j) {
          m4[j] *= sbi;
          i3[j] *= sbi;
          for (int r = 1; r <= 3; ++r) st[((i + r) & 3) * SEG + j * NT] *= sbi;
          for (int r = 1; r <= 2; ++r)
            st[(4 + (i + r) % 3) * SEG + j * NT] *= sbi;
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        st[v4 * SEG + j * NT] = m4[j];
        st[vi * SEG + j * NT] = i3[j];
      }
    }
    lsb += (double)logf(sb);
    if (g.t == 0) {
      double* r = spec + i;
      r[0] = xB * sbi;
      r[ld] = xN * sbi;
      r[2 * ld] = i >= 3 ? xJ * sbi : 0.f;
      r[3 * ld] = i >= 3 ? xC * sbi : 0.f;
      r[4 * ld] = xE * sbi;
      r[5 * ld] = lsb;
    }
    n3 = n2 * sbi;
    n2 = n1 * sbi;
    n1 = xN * sbi;
    jj3 = jj2 * sbi;
    jj2 = jj1 * sbi;
    jj1 = xJ * sbi;
    cc3 = cc2 * sbi;
    cc2 = cc1 * sbi;
    cc1 = xC * sbi;
  }
}

}  // namespace bt

namespace bt {

// The group's pass over its window: the Forward writes fspec and logz2,
// the Backward bspec.  SEG and S > 1: the segmented walks.
template <int P, bool DIRECT, bool SEG = false>
__device__ void fs3_decode(const Fs3Slot& s, const int8_t* __restrict__ dsq,
                           const int* __restrict__ lens, int L, float nj,
                           double* __restrict__ fspec,
                           double* __restrict__ bspec,
                           double* __restrict__ logz2) {
  const int b = s.b;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)(len / 3) + 2.f + nj);
  const int ld = L + 1;
  const int8_t* seq = dsq + (size_t)b * L;
  if constexpr (SEG) {
    if (s.S > 1) {
      if (s.pass == 0) {
        double lsf;
        const double logz = fs3_forward_pass_seg<P, true>(
            s.g, s.ring, s.ttab, s.Mp, s.S, seq, len, pmove, nj,
            fspec + (size_t)b * 6 * ld, ld, lsf, s.slot, s.cx);
        if (s.g.t == 0) {
          logz2[2 * b] = logz;
          logz2[2 * b + 1] = lsf;
        }
      } else {
        fs3_backward_pass_seg<P>(s.g, s.ring, s.ttab, s.M, s.Mp, s.S, seq,
                                 len, pmove, nj, bspec + (size_t)b * 6 * ld,
                                 ld, s.slot);
      }
      return;
    }
  }
  if (s.pass == 0) {
    double lsf;
    const double logz = fs3_forward_pass<P, true, DIRECT>(
        s.g, s.ring, s.ttab, s.Mp, seq, len, pmove, nj,
        fspec + (size_t)b * 6 * ld, ld, lsf);
    if (s.g.t == 0) {
      logz2[2 * b] = logz;
      logz2[2 * b + 1] = lsf;
    }
  } else {
    fs3_backward_pass<P, DIRECT>(s.g, s.ring, s.ttab, s.M, s.Mp, seq, len,
                                 pmove, nj, bspec + (size_t)b * 6 * ld, ld);
  }
}

}  // namespace bt

template <int MODE>
__device__ __forceinline__ void fs3_domdec_block(
    const int8_t* __restrict__ dsq, const int* __restrict__ lens, int L,
    float nj, double* __restrict__ fspec, double* __restrict__ bspec,
    double* __restrict__ logz2, const long long* __restrict__ plan, int ncls,
    int nblk) {
  extern __shared__ float4 smem4[];
  const bt::Fs3Slot s = bt::fs3_slot<MODE>(plan, ncls, nblk, 2,
                                           reinterpret_cast<char*>(smem4));
  if (s.b < 0) return;
#define BT_FS3_DECODE(PP)                                                    \
  bt::fs3_decode<PP, (MODE >= 1), (MODE >= 4)>(s, dsq, lens, L, nj, fspec,  \
                                               bspec, logz2)
  BT_FS3_DISPATCH(s.P, BT_FS3_DECODE)
#undef BT_FS3_DECODE
  if (MODE >= 4 && s.S > 1) seg_free(s.cls, s.sid);
}

// The ring and direct instances (MODE 0, 1) take the registers they
// need; the others are capped for blocks of 16 or 32 warps.
template <int MODE>
__global__ void fs3_domdec_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int L,
                                  float nj, double* __restrict__ fspec,
                                  double* __restrict__ bspec,
                                  double* __restrict__ logz2,
                                  const long long* __restrict__ plan,
                                  int ncls, int nblk) {
  fs3_domdec_block<MODE>(dsq, lens, L, nj, fspec, bspec, logz2, plan, ncls,
                         nblk);
}

template <int MODE>
__global__ void __launch_bounds__(fs3_threads(MODE))
    fs3_domdec_wide_kernel(const int8_t* __restrict__ dsq,
                           const int* __restrict__ lens, int L, float nj,
                           double* __restrict__ fspec,
                           double* __restrict__ bspec,
                           double* __restrict__ logz2,
                           const long long* __restrict__ plan, int ncls,
                           int nblk) {
  fs3_domdec_block<MODE>(dsq, lens, L, nj, fspec, bspec, logz2, plan, ncls,
                         nblk);
}

#define FS3_DOMDEC_ARGS                                                     \
  (const int8_t*)dsq, (const int*)lens, L, nj, (double*)fspec,              \
      (double*)bspec, (double*)logz2, (const long long*)plan, ncls, nblk

namespace bt {
// Launches the instances of MODE 2-4 (fs3_domdec_wide.cu).
int fs3_domdec_wide_launch(int mode, const void* dsq, const void* lens,
                           int L, float nj, void* fspec, void* bspec,
                           void* logz2, const void* plan, int ncls, int nblk,
                           int warps, size_t smem, void* stream);
}  // namespace bt

#ifndef BT_FS3_DOMDEC_WIDE
// dsq [B, L] int8 nucleotides (pad 17); lens [B] int32; fspec and bspec
// [B, 6, L+1] f64, zero-filled by the caller (rows past a window stay
// 0): per row xB, xN, xJ, xC, xE after the row's rescale and the log
// scale through the row; logz2 [B, 2] f64 = (logZ, total forward log
// scale); written at the plan's windows.  plan_host and plan: the
// plan's table (fs3_common.cuh) on the host and on the device, with ncls
// classes and nblk blocks of `warps` warps, two items a window.
// Returns the launch's cudaError_t.
extern "C" int bt_fs3_domdec(const void* dsq, const void* lens, int L,
                             float nj, void* fspec, void* bspec, void* logz2,
                             const long long* plan_host, const void* plan,
                             int ncls, int nblk, int warps, void* stream) {
  if (nblk <= 0) return 0;
  size_t smem;
  const int err = fs3_check(plan_host, ncls, warps, smem);
  if (err) return err;
  const int mode = fs3_mode(plan_host, ncls, warps);
  if (mode >= 2)
    return bt::fs3_domdec_wide_launch(mode, dsq, lens, L, nj, fspec, bspec,
                                      logz2, plan, ncls, nblk, warps, smem,
                                      stream);
  auto kernel = mode == 0 ? fs3_domdec_kernel<0> : fs3_domdec_kernel<1>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<nblk, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      FS3_DOMDEC_ARGS);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_fs3_domdec_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(bt::fs3_seg_slot_bytes(2, Mp), n);
}
#else
int bt::fs3_domdec_wide_launch(int mode, const void* dsq, const void* lens,
                               int L, float nj, void* fspec, void* bspec,
                               void* logz2, const void* plan, int ncls,
                               int nblk, int warps, size_t smem,
                               void* stream) {
  auto kernel = mode == 2   ? fs3_domdec_wide_kernel<2>
                : mode == 3 ? fs3_domdec_wide_kernel<3>
                            : fs3_domdec_wide_kernel<4>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<nblk, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      FS3_DOMDEC_ARGS);
  return (int)cudaGetLastError();
}
#endif
#undef FS3_DOMDEC_ARGS
