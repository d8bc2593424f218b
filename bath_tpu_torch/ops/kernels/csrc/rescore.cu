// Envelope rescoring of the standard branch: the unihit Forward with its
// full matrix, the Backward on the Forward's scales, posterior decoding
// and the optimal-accuracy (OA) fill, for every envelope of a batch in
// one launch.
//
// Replaces the native host fills that bath_tpu/domaindef.py runs for each
// envelope (rescore_isolated_domain_bath: native/src/bathio.cpp
// bio_fwd_fill, bio_bwd_fill, bio_decoding, bio_oa_fill); the TPU package
// runs them on the host.  The output is bit-identical to those fills, so
// the search's bytes do not depend on where an envelope was filled:
// - every float operation is the host's, in the host's order, rounded
//   once (__fmul_rn/__fadd_rn/__fdiv_rn: nothing is contracted into an
//   FMA; the host library is built with -ffp-contract=off);
// - the D->D chains (the Forward's dc[k] += dc[k-1]*tDD[k], the
//   Backward's from M-1 down, the OA fill's gated max) run sequentially
//   in one thread, in the host's order: a parallel scan would round
//   differently;
// - the row sums follow numpy's pairwise summation (np_pairwise_f32):
//   leaves of at most 128 elements, each summed by eight lanes in eight
//   strided accumulators and combined as ((r0+r1)+(r2+r3))+((r4+r5)+
//   (r6+r7)) plus the tail, and the leaves combined in the recursion's
//   order (the host's plan: ops/rescore.py pairwise_plan);
// - maxima are exact, so the OA row maxima are reduced across threads.
// No exp or log runs here: the host takes the logs of the scales.
//
// The design on the H100: one block an envelope (a batch is a flush's
// envelopes, each on an SM of its own), the k-parallel updates across the
// block's threads and the chains in thread 0.  The Backward writes no
// matrix of its own: each of its rows is multiplied into the Forward's
// row at once (the first product of decoding, (f*b)*totr), and the
// decoding's second product runs inside the OA fill's row loop, which
// reads the posterior row it has just written.  Five matrices an
// envelope reach global memory (posterior M and I, OA M, I and D), and
// twenty special rows.  The transitions and the working vectors stay in
// shared memory while they fit (M up to ~3400), else both are read from
// global memory (a scratch slice a block).
//
// An envelope's output region (ops/rescore.py region_floats): five
// (L+1) x (M+1) matrices, posterior M, posterior I, OA M, OA I, OA D,
// then twenty rows of L+1 specials (the order of the enum below), all
// written by the kernel; status[e] is 0, or 1-3 where the Forward's xC
// is NaN, underflows or overflows, 4-6 the same for the Backward's xN(0),
// 7 where decoding's scale product overflows (the host's RangeError).

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
enum { FXE, FXN, FXJ, FXB, FXC, FSC, BXE, BXN, BXJ, BXB, BXC, BSC,
       PXN, PXJ, PXC, OXE, OXN, OXJ, OXB, OXC };
// transition rows, the host fills' order (fwdback.py _trans_views)
enum { TBM, TMM, TIM, TDM, TMD, TDD, TMI, TII };
// the envelope's length model (native/__init__.py _xff_of)
enum { NLOOP, NMOVE, JLOOP, JMOVE, CLOOP, CMOVE, ELOOP, EMOVE };
// working vectors of M+1 floats
constexpr int NVEC = 8;
// block scalars
enum { S_XB, S_XE, S_INV, S_RESC, S_TOTR, S_OXB, S_WMAX = 8,
       S_WDMAX = S_WMAX + WARPS, NSCAL = 32 };
constexpr int SMEM_MAX = 227 * 1024;

__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// One leaf of the pairwise sum, n <= 128 elements of a: eight lanes of a
// warp (lane8 = 0..7), every lane of the warp calling; the sum in
// lane8 0.  n < 8: the host's sequential sum.
__device__ float leaf_sum(const float* a, int n, int lane8) {
  float r = 0.f;
  const int full = n - n % 8;
  if (n >= 8) {
    r = a[lane8];
#pragma unroll 4
    for (int i = 8; i < full; i += 8) r = fadd(r, a[i + lane8]);
  }
  float s = fadd(r, __shfl_down_sync(FULL, r, 1, 8));
  s = fadd(s, __shfl_down_sync(FULL, s, 2, 8));
  s = fadd(s, __shfl_down_sync(FULL, s, 4, 8));
  if (lane8 == 0) {
    // the sequential part: n < 8 values, or the tail after the eight
    // accumulators, read at once
    const int i0 = n < 8 ? 0 : full;
    float t[8];
#pragma unroll
    for (int j = 0; j < 8; j++) t[j] = i0 + j < n ? a[i0 + j] : 0.f;
    if (n < 8) s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; j++)
      if (i0 + j < n) s = fadd(s, t[j]);
  }
  return s;
}

// The leaves of the pairwise sum of a[0..n) into val[0..nleaf), over the
// warps from first_warp on, four leaves a warp at a time.  pw: [nleaf,
// nops, offsets, lengths, the ops' left and right operands].
__device__ void leaves(const float* a, const int* pw, float* val,
                       int first_warp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < first_warp) return;
  const int nleaf = pw[0];
  const int* off = pw + 2;
  const int* len = off + nleaf;
  const int nw = WARPS - first_warp;
  for (int base = (warp - first_warp) * 4; base < nleaf; base += nw * 4) {
    const int lf = base + (lane >> 3);
    const bool on = lf < nleaf;
    const float r = leaf_sum(a + (on ? off[lf] : 0), on ? len[lf] : 0,
                             lane & 7);
    if (on && (lane & 7) == 0) val[lf] = r;
  }
}

// The leaves combined in the recursion's order: op m (postorder) adds
// the values of its two operands into val[nleaf + m]; thread 0.
__device__ float tree(const int* pw, float* val) {
  const int nleaf = pw[0], nops = pw[1];
  const int* l = pw + 2 + 2 * nleaf;
  const int* r = l + nops;
  for (int m = 0; m < nops; m++)
    val[nleaf + m] = fadd(val[l[m]], val[r[m]]);
  return val[nleaf + nops - 1];
}

// The chains run in thread 0: v[k] = step(v[k], c[k], prev), prev the
// value the step before wrote, for the n indices k = first, first + D, ...
// (D = 1 or -1) in that order.  Runs of U values and coefficients are read
// into registers a run ahead, into two sets of registers in turn: with one
// set and a copy, the compiler moved each copy next to its load and every
// run waited on shared memory (25-31 cycles a step, 17-22 now).  Only the
// last, partial run is guarded.
constexpr int U = 8;

#define BT_LOAD(x, t, k0)                                                    \
  _Pragma("unroll") for (int u = 0; u < U; u++) {                            \
    x[u] = v[(k0) + D * u];                                                  \
    t[u] = c[(k0) + D * u];                                                  \
  }
#define BT_RUN(x, t, k0)                                                     \
  _Pragma("unroll") for (int u = 0; u < U; u++) {                            \
    prev = step(x[u], t[u], prev);                                           \
    v[(k0) + D * u] = prev;                                                  \
  }

template <int D, class Step>
__device__ __forceinline__ void chain(float* v, const float* c, int first,
                                      int n, float prev, Step step) {
  const int runs = n / U;
  int k = first, r = 0;
  float xa[U], ta[U], xb[U], tb[U];
  if (runs > 0) {
    BT_LOAD(xa, ta, k)
  }
  for (; r + 1 < runs; r += 2, k += 2 * D * U) {
    BT_LOAD(xb, tb, k + D * U)
    BT_RUN(xa, ta, k)
    if (r + 2 < runs) {
      BT_LOAD(xa, ta, k + 2 * D * U)
    }
    BT_RUN(xb, tb, k + D * U)
  }
  if (r < runs) {
    BT_RUN(xa, ta, k)
    k += D * U;
  }
  for (int j = runs * U; j < n; j++, k += D) {
    prev = step(v[k], c[k], prev);
    v[k] = prev;
  }
}
#undef BT_LOAD
#undef BT_RUN

// a pairwise sum's shared memory: the values of its leaves and ops (two
// sums a row), and its plan
__host__ __device__ __forceinline__ int vals_pad(int nleaf) {
  return (2 * nleaf + 31) & ~31;
}
__host__ __device__ __forceinline__ int plan_ints(int nleaf) {
  return 2 + 2 * nleaf + 2 * (nleaf - 1);
}
__host__ __device__ __forceinline__ int plan_pad(int nleaf) {
  return (plan_ints(nleaf) + 31) & ~31;
}
size_t leaf_bytes(int nleaf) {
  return sizeof(float) * (NSCAL + 2 * vals_pad(nleaf) + plan_pad(nleaf));
}

__device__ __forceinline__ int range_status(float x, int L, int base) {
  if (x != x) return base + 1;                       // NaN
  if (L > 0 && x == 0.f) return base + 2;            // underflow
  if (x == CUDART_INF_F || x == -CUDART_INF_F) return base + 3;
  return 0;
}

// The max of v over a warp (v never NaN); every lane gets it.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(FULL, v, o);
    if (t > v) v = t;
  }
  return v;
}

template <bool SH>
__global__ void __launch_bounds__(THREADS)
rescore_kernel(const int8_t* __restrict__ dsq,
               const long long* __restrict__ doff,
               const int* __restrict__ lens, const float* __restrict__ xffs,
               const long long* __restrict__ ooff,
               const float* __restrict__ rfv, const float* __restrict__ tv_g,
               const int* __restrict__ pw_g, int M, float* __restrict__ out,
               int* __restrict__ status, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int W = M + 1;
  const int tid = threadIdx.x;
  const int e = blockIdx.x;
  const int L = lens[e];
  const int8_t* sq = dsq + doff[e];
  float xf[8];
#pragma unroll
  for (int q = 0; q < 8; q++) xf[q] = xffs[8 * e + q];
  const float nloop = xf[NLOOP], nmove = xf[NMOVE], jloop = xf[JLOOP],
              jmove = xf[JMOVE], cloop = xf[CLOOP], cmove = xf[CMOVE],
              eloop = xf[ELOOP], emove = xf[EMOVE];
  const float NEG = -CUDART_INF_F;

  float* reg = out + ooff[e];
  const long long NW = (long long)(L + 1) * W;
  float* pmm = reg;
  float* pim = reg + NW;
  float* omm = reg + 2 * NW;
  float* oim = reg + 3 * NW;
  float* odm = reg + 4 * NW;
  float* spec = reg + 5 * NW;
  auto S = [&](int r) { return spec + (long long)r * (L + 1); };

  const int nleaf = pw_g[0];
  const int vpad = vals_pad(nleaf);
  float* sc = smem;
  float* leafm = smem + NSCAL;
  float* leafd = leafm + vpad;
  int* pw = reinterpret_cast<int*>(leafd + vpad);
  for (int q = tid; q < plan_ints(nleaf); q += THREADS) pw[q] = pw_g[q];
  const float* tv;
  float* work;
  if (SH) {
    float* t = reinterpret_cast<float*>(pw) + plan_pad(nleaf);
    for (int k = tid; k < 8 * W; k += THREADS) t[k] = tv_g[k];
    tv = t;
    work = t + 8 * W;
  } else {
    tv = tv_g;
    work = scratch + (long long)e * NVEC * W;
  }
  const float* tBM = tv + TBM * W;
  const float* tMM = tv + TMM * W;
  const float* tIM = tv + TIM * W;
  const float* tDM = tv + TDM * W;
  const float* tMD = tv + TMD * W;
  const float* tDD = tv + TDD * W;
  const float* tMI = tv + TMI * W;
  const float* tII = tv + TII * W;
  float* mc = work;
  float* ic = work + W;
  float* dc = work + 2 * W;
  float* nm = work + 3 * W;
  float* ni = work + 4 * W;
  float* nd = work + 5 * W;
  float* ms = work + 6 * W;
  float* tb = work + 7 * W;

  // ---- Forward (bio_fwd_fill, full) --------------------------------
  for (int k = tid; k < W; k += THREADS) {
    mc[k] = ic[k] = dc[k] = 0.f;
    pmm[k] = pim[k] = 0.f;
  }
  float xN = 1.f, xB = nmove, xE = 0.f, xJ = 0.f, xC = 0.f;
  if (tid == 0) {
    S(FXE)[0] = 0.f;
    S(FXN)[0] = xN;
    S(FXJ)[0] = 0.f;
    S(FXB)[0] = xB;
    S(FXC)[0] = 0.f;
    S(FSC)[0] = 1.f;
    sc[S_XB] = xB;
  }
  __syncthreads();
  float* sv = ms;
  int res = sq[0];
  for (int i = 1; i <= L; i++) {
    const float* row = rfv + (long long)res * W;
    if (i < L) res = sq[i];
    const float xBs = sc[S_XB];
    for (int k = tid + 1; k <= M; k += THREADS)
      sv[k] = fmul(fadd(fadd(fadd(fmul(xBs, tBM[k]), fmul(mc[k - 1], tMM[k])),
                             fmul(ic[k - 1], tIM[k])),
                        fmul(dc[k - 1], tDM[k])),
                   row[k]);
    if (tid == 0) sv[0] = 0.f;
    __syncthreads();
    for (int k = tid; k <= M; k += THREADS)
      ic[k] = fadd(fmul(mc[k], tMI[k]), fmul(ic[k], tII[k]));
    for (int k = tid + 2; k <= M; k += THREADS)
      dc[k] = fmul(sv[k - 1], tMD[k]);
    if (tid == 0) {
      ic[0] = 0.f;
      dc[0] = dc[1] = 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      chain<1>(dc, tDD, 2, M - 1, dc[1], [](float x, float t, float d) {
        return fadd(x, fmul(d, t));
      });
    }
    leaves(sv + 1, pw, leafm, 1);
    __syncthreads();
    leaves(dc + 1, pw, leafd, 0);
    __syncthreads();
    if (tid == 0) {
      xE = fadd(tree(pw, leafm), tree(pw, leafd));
      xN = fmul(xN, nloop);
      xC = fadd(fmul(xC, cloop), fmul(xE, emove));
      xJ = fadd(fmul(xJ, jloop), fmul(xE, eloop));
      xB = fadd(fmul(xJ, jmove), fmul(xN, nmove));
      float inv = 1.f, s = 1.f;
      if (xE > 1.0e4f) {
        s = xE;
        xN = fdiv(xN, s);
        xC = fdiv(xC, s);
        xJ = fdiv(xJ, s);
        xB = fdiv(xB, s);
        inv = fdiv(1.f, s);
        xE = 1.f;
      }
      S(FSC)[i] = s;
      S(FXE)[i] = xE;
      S(FXN)[i] = xN;
      S(FXJ)[i] = xJ;
      S(FXB)[i] = xB;
      S(FXC)[i] = xC;
      sc[S_INV] = inv;
      sc[S_RESC] = s > 1.f ? 1.f : 0.f;
      sc[S_XB] = xB;
    }
    __syncthreads();
    const bool resc = sc[S_RESC] != 0.f;
    const float inv = sc[S_INV];
    float* pr = pmm + (long long)i * W;
    float* ir = pim + (long long)i * W;
    for (int k = tid; k <= M; k += THREADS) {
      float m = sv[k], ii = ic[k];
      if (resc) {
        m = fmul(m, inv);
        ii = fmul(ii, inv);
        sv[k] = m;
        ic[k] = ii;
        dc[k] = fmul(dc[k], inv);
      }
      pr[k] = m;
      ir[k] = ii;
    }
    float* t = mc;
    mc = sv;
    sv = t;
    __syncthreads();
  }
  int st = 0;
  if (tid == 0) st = range_status(xC, L, 0);
  ms = sv;

  // ---- Backward (bio_bwd_fill, full), each row multiplied into the
  // Forward's: the first product of decoding ----------------------------
  int own = 0;
  if (tid == 0) {
    xJ = 0.f;
    xB = 0.f;
    xN = 0.f;
    xC = cmove;
    xE = fmul(xC, emove);
    sc[S_XE] = xE;
  }
  __syncthreads();
  {
    const float xEL = sc[S_XE];
    for (int k = tid; k <= M; k += THREADS) {
      mc[k] = dc[k] = (k == 0) ? 0.f : xEL;
      ic[k] = 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      chain<-1>(dc, tDD + 1, M - 1, M - 1, dc[M],
                [](float x, float t, float d) { return fadd(x, fmul(d, t)); });
    }
    __syncthreads();
    for (int k = tid + 1; k < M; k += THREADS)
      mc[k] = fadd(mc[k], fmul(dc[k + 1], tMD[k + 1]));
    if (tid == 0) {
      const float scL = S(FSC)[L];
      float inv = 1.f;
      if (scL > 1.0f) {
        inv = fdiv(1.f, scL);
        xE = fmul(xE, inv);
        xN = fmul(xN, inv);
        xC = fmul(xC, inv);
        xJ = fmul(xJ, inv);
        xB = fmul(xB, inv);
      }
      S(BSC)[L] = scL;
      S(BXE)[L] = xE;
      S(BXN)[L] = xN;
      S(BXJ)[L] = xJ;
      S(BXB)[L] = xB;
      S(BXC)[L] = xC;
      sc[S_INV] = inv;
      sc[S_RESC] = scL > 1.f ? 1.f : 0.f;
    }
    __syncthreads();
    const bool resc = sc[S_RESC] != 0.f;
    const float inv = sc[S_INV];
    float* pr = pmm + (long long)L * W;
    float* ir = pim + (long long)L * W;
    for (int k = tid; k <= M; k += THREADS) {
      float m = mc[k], ii = ic[k];
      if (resc) {
        m = fmul(m, inv);
        ii = fmul(ii, inv);
        mc[k] = m;
        ic[k] = ii;
        dc[k] = fmul(dc[k], inv);
      }
      pr[k] = fmul(pr[k], m);
      ir[k] = fmul(ir[k], ii);
    }
    __syncthreads();
  }
  // the next row's residue, and (thread 0) its Forward scale, a row ahead
  res = sq[L - 1];
  float fsn = 1.f;
  if (tid == 0 && L > 1) fsn = S(FSC)[L - 1];
  for (int i = L - 1; i >= 1; i--) {
    const float* row = rfv + (long long)res * W;
    res = sq[i - 1];
    const float fsi = fsn;
    if (tid == 0 && i > 1) fsn = S(FSC)[i - 1];
    for (int k = tid + 1; k <= M; k += THREADS) {
      const float v = fmul(mc[k], row[k]);
      ms[k] = v;
      tb[k - 1] = fmul(v, tBM[k]);
    }
    if (tid == 0) ms[0] = 0.f;
    __syncthreads();
    leaves(tb, pw, leafm, 0);
    for (int k = tid + 1; k <= M; k += THREADS) {
      const bool in = k < M;
      const float ms1 = in ? ms[k + 1] : 0.f;
      const float tMMk = in ? tMM[k + 1] : 0.f;
      const float tIMk = in ? tIM[k + 1] : 0.f;
      const float tDMk = in ? tDM[k + 1] : 0.f;
      ni[k] = fadd(fmul(ic[k], tII[k]), fmul(ms1, tIMk));
      nm[k] = fadd(fmul(ic[k], tMI[k]), fmul(ms1, tMMk));
      nd[k] = fmul(ms1, tDMk);
    }
    if (tid == 0) nm[0] = ni[0] = nd[0] = 0.f;
    __syncthreads();
    if (tid == 0) {
      xB = tree(pw, leafm);
      xC = fmul(xC, cloop);
      xJ = fadd(fmul(xB, jmove), fmul(xJ, jloop));
      xN = fadd(fmul(xB, nmove), fmul(xN, nloop));
      xE = fadd(fmul(xC, emove), fmul(xJ, eloop));
      sc[S_XE] = xE;
      // nd[k] += xE, then the chain from M-1 down
      const float xEc = xE;
      nd[M] = fadd(nd[M], xEc);
      chain<-1>(nd, tDD + 1, M - 1, M - 1, nd[M],
                [xEc](float x, float t, float d) {
                  return fadd(fadd(x, xEc), fmul(d, t));
                });
      if (xB > 1.0e16f) own = 1;
      const float s = own ? ((xB > 1.0e4f) ? xB : 1.0f) : fsi;
      float inv = 1.f;
      if (s > 1.0f) {
        inv = fdiv(1.f, s);
        xE = fmul(xE, inv);
        xN = fmul(xN, inv);
        xJ = fmul(xJ, inv);
        xB = fmul(xB, inv);
        xC = fmul(xC, inv);
      }
      S(BSC)[i] = s;
      S(BXE)[i] = xE;
      S(BXN)[i] = xN;
      S(BXJ)[i] = xJ;
      S(BXB)[i] = xB;
      S(BXC)[i] = xC;
      sc[S_INV] = inv;
      sc[S_RESC] = s > 1.f ? 1.f : 0.f;
    }
    __syncthreads();
    {
      const float xEr = sc[S_XE];
      for (int k = tid + 1; k <= M; k += THREADS)
        nm[k] = k < M ? fadd(fadd(nm[k], xEr), fmul(nd[k + 1], tMD[k + 1]))
                      : fadd(nm[k], xEr);
    }
    __syncthreads();
    const bool resc = sc[S_RESC] != 0.f;
    const float inv = sc[S_INV];
    float* pr = pmm + (long long)i * W;
    float* ir = pim + (long long)i * W;
    for (int k = tid; k <= M; k += THREADS) {
      float m = nm[k], ii = ni[k];
      if (resc) {
        m = fmul(m, inv);
        ii = fmul(ii, inv);
        nm[k] = m;
        ni[k] = ii;
        nd[k] = fmul(nd[k], inv);
      }
      pr[k] = fmul(pr[k], m);
      ir[k] = fmul(ir[k], ii);
    }
    float* t;
    t = mc; mc = nm; nm = t;
    t = ic; ic = ni; ni = t;
    t = dc; dc = nd; nd = t;
    __syncthreads();
  }
  // termination at row 0
  {
    const float* row = rfv + (long long)res * W;
    for (int k = tid + 1; k <= M; k += THREADS)
      tb[k - 1] = fmul(fmul(mc[k], row[k]), tBM[k]);
    __syncthreads();
    leaves(tb, pw, leafm, 0);
    __syncthreads();
    if (tid == 0) {
      xB = tree(pw, leafm);
      xN = fadd(fmul(xB, nmove), fmul(xN, nloop));
      S(BXE)[0] = 0.f;
      S(BXN)[0] = xN;
      S(BXJ)[0] = 0.f;
      S(BXB)[0] = xB;
      S(BXC)[0] = 0.f;
      S(BSC)[0] = 1.f;
      if (!st) st = range_status(xN, L, 3);
    }
  }

  // ---- decoding's second product and the OA fill (bio_decoding,
  // bio_oa_fill) ------------------------------------------------------
  float* mp = mc;
  float* ip = ic;
  float* dp = dc;
  float* mr = nm;
  float* ir = ni;
  float* dr = nd;
  for (int k = tid; k <= M; k += THREADS) {
    mp[k] = ip[k] = dp[k] = NEG;
    omm[k] = oim[k] = odm[k] = NEG;
  }
  float sp = 0.f, oJ = NEG, oC = NEG, oN = 0.f;
  if (tid == 0) {
    sp = fdiv(1.f, S(BXN)[0]);
    S(PXN)[0] = S(PXJ)[0] = S(PXC)[0] = 0.f;
    S(OXE)[0] = NEG;
    S(OXN)[0] = 0.f;
    S(OXJ)[0] = NEG;
    S(OXB)[0] = 0.f;
    S(OXC)[0] = NEG;
    sc[S_OXB] = 0.f;
  }
  float pxJ = 0.f, pxC = 0.f;
  // thread 0: the specials decoding reads, a row ahead
  float nx[8];
  auto fetch = [&](int i) {
    nx[0] = S(FSC)[i];
    nx[1] = S(BSC)[i];
    nx[2] = S(FXN)[i - 1];
    nx[3] = S(BXN)[i];
    nx[4] = S(FXJ)[i - 1];
    nx[5] = S(BXJ)[i];
    nx[6] = S(FXC)[i - 1];
    nx[7] = S(BXC)[i];
  };
  if (tid == 0) fetch(1);
  for (int i = 1; i <= L; i++) {
    if (tid == 0) {
      float x[8];
#pragma unroll
      for (int q = 0; q < 8; q++) x[q] = nx[q];
      if (i < L) fetch(i + 1);
      sc[S_TOTR] = fmul(sp, x[0]);
      const float pxN = fmul(fmul(fmul(x[2], x[3]), nloop), sp);
      pxJ = fmul(fmul(fmul(x[4], x[5]), jloop), sp);
      pxC = fmul(fmul(fmul(x[6], x[7]), cloop), sp);
      S(PXN)[i] = pxN;
      S(PXJ)[i] = pxJ;
      S(PXC)[i] = pxC;
      if (own) sp = fdiv(fmul(sp, x[0]), x[1]);
      oN = (nloop == 0.f) ? 0.f : fadd(oN, pxN);
    }
    __syncthreads();
    const float totr = sc[S_TOTR];
    const float xBp = sc[S_OXB];
    float* prow = pmm + (long long)i * W;
    float* qrow = pim + (long long)i * W;
    float mmax = NEG;
    for (int k = tid; k <= M; k += THREADS) {
      const float pm = fmul(prow[k], totr);
      const float pi = fmul(qrow[k], totr);
      prow[k] = pm;
      qrow[k] = pi;
      if (k == 0) continue;
      float v = (tBM[k] > 0.f) ? xBp : 0.f;
      float t = (tMM[k] > 0.f) ? mp[k - 1] : 0.f;
      if (t > v) v = t;
      t = (tIM[k] > 0.f) ? ip[k - 1] : 0.f;
      if (t > v) v = t;
      t = (tDM[k] > 0.f) ? dp[k - 1] : 0.f;
      if (t > v) v = t;
      const float m = fadd(v, pm);
      mr[k] = m;
      if (m > mmax) mmax = m;
      float iv = (tMI[k] > 0.f) ? mp[k] : 0.f;
      t = (tII[k] > 0.f) ? ip[k] : 0.f;
      if (t > iv) iv = t;
      ir[k] = fadd(iv, pi);
    }
    if (tid == 0) {
      mr[0] = NEG;
      ir[0] = NEG;
    }
    __syncthreads();
    for (int k = tid + 2; k <= M; k += THREADS)
      dr[k] = (tMD[k] > 0.f) ? mr[k - 1] : 0.f;
    if (tid == 0) dr[0] = dr[1] = NEG;
    __syncthreads();
    if (tid == 0) {
      chain<1>(dr, tDD, 2, M - 1, dr[1], [](float x, float t, float d) {
        const float g = (t > 0.f) ? d : 0.f;
        return (g > x) ? g : x;
      });
    }
    __syncthreads();
    float dmax = NEG;
    float* om = omm + (long long)i * W;
    float* oi = oim + (long long)i * W;
    float* od = odm + (long long)i * W;
    for (int k = tid; k <= M; k += THREADS) {
      const float d = dr[k];
      if (k >= 1 && d > dmax) dmax = d;
      om[k] = mr[k];
      oi[k] = ir[k];
      od[k] = d;
    }
    mmax = warp_max(mmax);
    dmax = warp_max(dmax);
    if ((tid & 31) == 0) {
      sc[S_WMAX + (tid >> 5)] = mmax;
      sc[S_WDMAX + (tid >> 5)] = dmax;
    }
    __syncthreads();
    if (tid == 0) {
      float a = NEG, b = NEG;
      for (int w = 0; w < WARPS; w++) {
        if (sc[S_WMAX + w] > a) a = sc[S_WMAX + w];
        if (sc[S_WDMAX + w] > b) b = sc[S_WDMAX + w];
      }
      const float xEo = a > b ? a : b;
      S(OXE)[i] = xEo;
      double t1 = (jloop == 0.f) ? 0.0 : (double)fadd(oJ, pxJ);
      double t2 = (eloop == 0.f) ? 0.0 : (double)xEo;
      oJ = (float)(t1 > t2 ? t1 : t2);
      t1 = (cloop == 0.f) ? 0.0 : (double)fadd(oC, pxC);
      t2 = (emove == 0.f) ? 0.0 : (double)xEo;
      oC = (float)(t1 > t2 ? t1 : t2);
      t1 = (nmove == 0.f) ? 0.0 : (double)oN;
      t2 = (jmove == 0.f) ? 0.0 : (double)oJ;
      const float oB = (float)(t1 > t2 ? t1 : t2);
      S(OXJ)[i] = oJ;
      S(OXC)[i] = oC;
      S(OXN)[i] = oN;
      S(OXB)[i] = oB;
      sc[S_OXB] = oB;
    }
    float* t;
    t = mp; mp = mr; mr = t;
    t = ip; ip = ir; ir = t;
    t = dp; dp = dr; dr = t;
  }
  if (tid == 0) {
    if (!st && (sp == CUDART_INF_F || sp == -CUDART_INF_F)) st = 7;
    status[e] = st;
  }
}

// dynamic shared memory of the instance that keeps the transitions and
// the working vectors in shared memory
size_t shared_bytes(int M, int nleaf) {
  return leaf_bytes(nleaf) + sizeof(float) * (8 + NVEC) * (size_t)(M + 1);
}

}  // namespace

// Floats of global scratch a block needs: 0 where the shared-memory
// instance runs (its working vectors fit a block's shared memory).
extern "C" long long bt_rescore_scratch_floats(int M, int nleaf) {
  return shared_bytes(M, nleaf) <= (size_t)SMEM_MAX
             ? 0
             : (long long)NVEC * (M + 1);
}

extern "C" int bt_rescore(const void* dsq, const void* doff, const void* lens,
                          const void* xff, const void* ooff, const void* rfv,
                          const void* tv, const void* pw, int M, int nleaf,
                          void* out, void* status, void* scratch, int B,
                          void* stream) {
  if (B <= 0) return 0;
  const size_t sh = shared_bytes(M, nleaf);
  const bool in_shared = sh <= (size_t)SMEM_MAX;
  const size_t smem = in_shared ? sh : leaf_bytes(nleaf);
  const auto kernel = in_shared ? rescore_kernel<true> : rescore_kernel<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<B, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dsq), static_cast<const long long*>(doff),
      static_cast<const int*>(lens), static_cast<const float*>(xff),
      static_cast<const long long*>(ooff), static_cast<const float*>(rfv),
      static_cast<const float*>(tv), static_cast<const int*>(pw), M,
      static_cast<float*>(out), static_cast<int*>(status),
      static_cast<float*>(scratch));
  return (int)cudaGetLastError();
}
