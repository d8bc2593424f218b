// Fused Forward + Backward parser + domain decoding for F3 survivors.
//
// Replaces bath_tpu/ops/jaxk/kernels.py _domdec_mb_impl (the jnp
// kernel that the TPU runs for p7_BackwardParser + p7_DomainDecoding).
// Per ORF: a forward pass that stores the six specials of every row
// (forward_pass<P, true>, shared with the gate), then a backward pass
// whose D->D chain is a suffix scan along k, which at each row emits
// the posterior increments of domain begin (inc_b), end (inc_e) and
// N/J/C occupancy (njr) already normalised by exp(logw - logZ).  The
// cumsum over rows and the `ok` test run as tensor ops after the
// kernel.
//
// What bounds it on the H100: like the gate, a latency chain of 2L
// dependent rows per ORF, each with a group-wide reduction (xB) and a
// group-wide scan; the design is the gate's (one warp per ORF up to
// M = 1056, many ORFs per SM), and the host-side cadence of the
// rescaling (forward xE > 1e4, backward xB outside [1e-4, 1e4]) is
// kept so the posteriors track the host kernel to ~1e-5.
//
// The multi-model entry bt_domdec_multi replaces
// bath_tpu/ops/jaxk/multimodel.py domdec_pack_batch (build_domdec_pack):
// item b is decoded under model slot[b].  It is this same kernel, item
// for item the same arithmetic; the TPU's lane packing is not carried
// over.  The tables of the models of one padded width Mp are stacked
// [G, Kp, Mp] and [G, 8, Mp] with their lengths Ms [G]; a block finds
// its model and its items in a per-block table (BtItem in
// dp_common.cuh); one launch per Mp.  The bound is the single-model
// one, 2L dependent rows per ORF.

#include "dp_common.cuh"

namespace bt {

template <int P>
__device__ void backward_pass(const Group& g, const float* etab,
                              const float* ttab, int M, int Mp,
                              const int8_t* __restrict__ seq, int len,
                              float pmove, float nj, const double* spec,
                              int ld, double logz, float* inc_b, float* inc_e,
                              float* njr) {
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
  float xNb = 0.f, xJb = 0.f, xCb = pmove, xEb = xE_L;
  double lsb = 0.0;
  for (int q = 0; q < len; ++q) {
    const int jrow = len - q;                 // output row, 1-based
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
      __syncthreads();
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
    // decoding terms of row jrow from the forward specials
    const double* fj = spec + jrow;           // forward row jrow
    const double* fm = spec + jrow - 1;       // forward row jrow-1
    const float term_e = (float)fj[4 * ld] * xEb;
    const float w_e = (float)(fj[5 * ld] + lsb - logz);
    const float njcp = ((float)fm[ld] * xNb + (float)fm[2 * ld] * xJb +
                        (float)fm[3 * ld] * xCb) * ploop;
    const float term_b = (float)fm[0] * xBn;
    const float w_m = (float)(fm[5 * ld] + lsb - logz);
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
    xEb = xEn * sbi;
    lsb += (double)logf(sb);
    if (g.t == 0) {
      inc_e[jrow - 1] = term_e * expf(w_e);
      inc_b[jrow - 1] = term_b * expf(w_m);
      njr[jrow - 1] = njcp * expf(w_m);
    }
  }
}

}  // namespace bt

template <int P>
__global__ void domdec_kernel(const int8_t* __restrict__ dsq,
                              const int* __restrict__ lens, int B, int L,
                              const float* __restrict__ etab_g,
                              const float* __restrict__ ttab_g, int Kp,
                              int M, int Mp, int W, bool tab_in_smem, float nj,
                              double* __restrict__ spec, float* __restrict__ inc_b,
                              float* __restrict__ inc_e, float* __restrict__ njr,
                              float* __restrict__ logz2,
                              const int* __restrict__ Ms,
                              const int* __restrict__ blk,
                              const int* __restrict__ order) {
  extern __shared__ float smem[];
  const BtItem it = bt_item(blk, order, B, W);
  if (Ms != nullptr) M = Ms[it.model];
  const float *etab, *ttab;
  bt::load_tables(etab_g + (size_t)it.model * Kp * Mp,
                  ttab_g + (size_t)it.model * bt::NTR * Mp, Kp, Mp, smem,
                  tab_in_smem, etab, ttab);
  const size_t tab_floats = tab_in_smem ? (size_t)(Kp + bt::NTR) * Mp : 0;
  const bt::Group g = bt_group(W, smem, tab_floats);
  const int b = it.b;
  if (b < 0) return;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)len + 2.f + nj);
  const int ld = L + 1;
  double* sp = spec + (size_t)b * 6 * ld;
  const int8_t* seq = dsq + (size_t)b * L;
  double lsf;
  const double logz = bt::forward_pass<P, true>(g, etab, ttab, Mp, seq, len,
                                                pmove, nj, sp, ld, lsf);
  // the backward reads rows the group's thread 0 wrote
  if (W > 1) __syncthreads(); else __syncwarp();
  bt::backward_pass<P>(g, etab, ttab, M, Mp, seq, len, pmove, nj, sp, ld,
                       logz, inc_b + (size_t)b * L, inc_e + (size_t)b * L,
                       njr + (size_t)b * L);
  if (g.t == 0) {
    logz2[2 * b] = (float)logz;
    logz2[2 * b + 1] = (float)(logz - lsf);
  }
}

// One launch of `blocks` blocks; Ms/blk/order null for a single model.
static int domdec_launch(const BtLaunch& l, int blocks, const void* dsq,
                         const void* lens, int B, int L, const void* etab,
                         const void* ttab, int Kp, int M, int Mp, int P,
                         float nj, void* spec, void* inc_b, void* inc_e,
                         void* njr, void* logz2, const void* Ms,
                         const void* blk, const void* order, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_DD(PP)                                                     \
  {                                                                          \
    cudaFuncSetAttribute(domdec_kernel<PP>,                                  \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    domdec_kernel<PP><<<blocks, l.threads, l.smem, st>>>(                    \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, Kp, M, Mp, l.W, l.tab_in_smem, nj,               \
        (double*)spec, (float*)inc_b, (float*)inc_e, (float*)njr,            \
        (float*)logz2, (const int*)Ms, (const int*)blk, (const int*)order);  \
  }
  BT_DISPATCH_P(P, BT_LAUNCH_DD)
#undef BT_LAUNCH_DD
  return (int)cudaGetLastError();
}

// dsq [B, L] int8; lens [B] int32; etab [Kp, Mp], ttab [8, Mp] (zero
// past the model, which has M positions); spec [B, 6, L+1] f64
// scratch; inc_b, inc_e, njr [B, L] f32, zero-filled by the caller
// (rows past an item's length stay 0); logz2 [B, 2] = (logZ, logZ minus
// the total forward log scale).
// Returns the launch's cudaError_t.
extern "C" int bt_domdec(const void* dsq, const void* lens, int B, int L,
                         const void* etab, const void* ttab, int Kp, int M,
                         int Mp, int P, float nj, void* spec, void* inc_b,
                         void* inc_e, void* njr, void* logz2, void* stream) {
  if (B <= 0) return 0;
  if (Mp % (32 * P) != 0 || M > Mp) return cudaErrorInvalidValue;
  const BtLaunch l = bt_plan(B, Kp, Mp, P, 100 * 1024);
  return domdec_launch(l, l.blocks, dsq, lens, B, L, etab, ttab, Kp, M, Mp, P,
                       nj, spec, inc_b, inc_e, njr, logz2, nullptr, nullptr,
                       nullptr, stream);
}

// The multi-model entry: etab [G, Kp, Mp], ttab [G, 8, Mp] and Ms [G]
// int32 stack the models of padded width Mp; blk [nblocks, 3] int32 =
// (model, first, count) per block and order [.] int32 the item rows
// (BtItem); every block holds at most `per_block` items, which must be
// the plan's.  The outputs, shaped as bt_domdec's over the whole batch,
// are written at the listed items only.
extern "C" int bt_domdec_multi(const void* dsq, const void* lens, int B,
                               int L, const void* etab, const void* ttab,
                               const void* Ms, int Kp, int Mp, int P,
                               float nj, void* spec, void* inc_b,
                               void* inc_e, void* njr, void* logz2,
                               const void* blk, const void* order,
                               int nblocks, int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = bt_plan(B, Kp, Mp, P, 100 * 1024);
  if (per_block != l.G) return cudaErrorInvalidValue;
  return domdec_launch(l, nblocks, dsq, lens, B, L, etab, ttab, Kp, 0, Mp, P,
                       nj, spec, inc_b, inc_e, njr, logz2, Ms, blk, order,
                       stream);
}
