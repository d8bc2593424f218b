// Fused fs3 Forward + Backward parser for frameshift domain decoding of
// the DNA windows that pass the fs3 gate and arbitration.
//
// Replaces bath_tpu/ops/jaxk/kernels.py _fs3_domdec_impl (the jnp
// kernel that the TPU runs for p7_BackwardParser_Frameshift_3Codons +
// p7_DomainDecoding_Frameshift).  Per window: the fs3 Forward of
// fs3_common.cuh with the host's sparse rescale cadence, storing the six
// specials of every nucleotide row in f64, then the Backward parser,
// storing its six specials per row the same way.  The stride-3 combine
// into btot/etot/mocc, its exp(logw - logZ) weights and the cumsums run
// as tensor ops after the kernel (ops/fs3_domdec.py finish), shared
// with the plain version.
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
// What bounds it on the H100: like the gate, a latency chain (2L + 1
// dependent rows per window), each row with a group-wide reduction (xB)
// and a group-wide scan, and three codon rows of odds read through
// L1/L2 per row and pass.  One warp per window up to M = 416, as the
// gate.  The backward keeps 7P ring floats a thread (M of four rows, I
// of three) and rotates them by copies.
//
// The multi-model entry bt_fs3_domdec_multi replaces
// bath_tpu/ops/jaxk/multimodel.py fs3_domdec_pack_batch
// (build_fs3_domdec_pack): window b is decoded under model slot[b].  It
// is this same kernel, item for item the same arithmetic; the TPU's lane
// packing is not carried over.  The tables of the models of one padded
// width Mp are stacked [G, 338, Mp] and [G, 8, Mp] with their lengths
// Ms [G]; a block finds its model and its windows in a per-block table
// (BtItem in dp_common.cuh); one launch per Mp.  The per-window dec_loop
// enters only the combine (ops/fs3_domdec.py finish), not the kernel.

#include "fs3_common.cuh"

namespace bt {

template <int P>
__device__ void fs3_backward_pass(const Group& g, const float* __restrict__ etab,
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
  // nucleotides of rows i+1..i+4 (rows past the window are never read)
  int y1 = FS3_PLACE, y2 = FS3_PLACE, y3 = FS3_PLACE, y4 = FS3_PLACE;
  double lsb = 0.0;
  for (int i = len; i >= 0; --i) {
    y4 = y3;
    y3 = y2;
    y2 = y1;
    y1 = i < len ? fs3_nt(seq[i]) : FS3_PLACE;   // row i+1
    float ivxb[P];
    float part = 0.f;
    {
      // the codon of c nt ending at row i+c, for i+c <= len
      const float* e2 = i + 2 <= len
          ? etab + (size_t)fs3_codons(y2, y1, 0, 0).c2 * Mp + k0 : nullptr;
      const float* e3 = i + 3 <= len
          ? etab + (size_t)fs3_codons(y3, y2, y1, 0).c3 * Mp + k0 : nullptr;
      const float* e4 = i + 4 <= len
          ? etab + (size_t)fs3_codons(y4, y3, y2, y1).c4 * Mp + k0 : nullptr;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float v = 0.f;
        if (e2) v += m2[j] * __ldg(e2 + j);
        if (e3) v += m3[j] * __ldg(e3 + j);
        if (e4) v += m4[j] * __ldg(e4 + j);
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
      __syncthreads();
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

}  // namespace bt

template <int P>
__global__ void fs3_domdec_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int B, int L,
                                  const float* __restrict__ etab,
                                  const float* __restrict__ ttab_g, int M,
                                  int Mp, int W, float nj,
                                  double* __restrict__ fspec,
                                  double* __restrict__ bspec,
                                  double* __restrict__ logz2, int erows,
                                  const int* __restrict__ Ms,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ order) {
  extern __shared__ float smem[];
  const BtItem it = bt_item(blk, order, B, W);
  if (Ms != nullptr) M = Ms[it.model];
  etab += (size_t)it.model * erows * Mp;
  const float *unused, *ttab;
  bt::load_tables(nullptr, ttab_g + (size_t)it.model * bt::NTR * Mp, 0, Mp,
                  smem, true, unused, ttab);
  const bt::Group g = bt_group(W, smem, (size_t)bt::NTR * Mp);
  const int b = it.b;
  if (b < 0) return;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)(len / 3) + 2.f + nj);
  const int ld = L + 1;
  const int8_t* seq = dsq + (size_t)b * L;
  double lsf;
  const double logz = bt::fs3_forward_pass<P, true>(
      g, etab, ttab, Mp, seq, len, pmove, nj, fspec + (size_t)b * 6 * ld, ld,
      lsf);
  // the backward reuses the exchange scratch the forward last read
  if (W > 1) __syncthreads(); else __syncwarp();
  bt::fs3_backward_pass<P>(g, etab, ttab, M, Mp, seq, len, pmove, nj,
                           bspec + (size_t)b * 6 * ld, ld);
  if (g.t == 0) {
    logz2[2 * b] = logz;
    logz2[2 * b + 1] = lsf;
  }
}

// One launch of `blocks` blocks; Ms/blk/order null for a single model
// (erows, the emission rows of one model of a stack, is then unused).
static int fs3_domdec_launch(const BtLaunch& l, int blocks, const void* dsq,
                             const void* lens, int B, int L, const void* etab,
                             const void* ttab, int M, int Mp, int P, float nj,
                             void* fspec, void* bspec, void* logz2, int erows,
                             const void* Ms, const void* blk,
                             const void* order, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_FS3DD(PP)                                                  \
  {                                                                          \
    cudaFuncSetAttribute(fs3_domdec_kernel<PP>,                              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    fs3_domdec_kernel<PP><<<blocks, l.threads, l.smem, st>>>(                \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, M, Mp, l.W, nj, (double*)fspec, (double*)bspec,  \
        (double*)logz2, erows, (const int*)Ms, (const int*)blk,              \
        (const int*)order);                                                  \
  }
  BT_DISPATCH_FS3_P(P, BT_LAUNCH_FS3DD)
#undef BT_LAUNCH_FS3DD
  return (int)cudaGetLastError();
}

// dsq [B, L] int8 nucleotides (pad 17); lens [B] int32; etab [338, Mp],
// ttab [8, Mp] (zero past the model, which has M positions); fspec and
// bspec [B, 6, L+1] f64, zero-filled by the caller (rows past a window
// stay 0): per row xB, xN, xJ, xC, xE after the row's rescale and the
// log scale through the row; logz2 [B, 2] f64 = (logZ, total forward
// log scale).  Returns the launch's cudaError_t.
extern "C" int bt_fs3_domdec(const void* dsq, const void* lens, int B, int L,
                             const void* etab, const void* ttab, int M,
                             int Mp, int P, float nj, void* fspec,
                             void* bspec, void* logz2, void* stream) {
  if (B <= 0) return 0;
  if (Mp % (32 * P) != 0 || M > Mp) return cudaErrorInvalidValue;
  const BtLaunch l = fs3_plan(B, Mp, P);
  return fs3_domdec_launch(l, l.blocks, dsq, lens, B, L, etab, ttab, M, Mp, P,
                           nj, fspec, bspec, logz2, 0, nullptr, nullptr,
                           nullptr, stream);
}

// The multi-model entry: etab [G, erows, Mp], ttab [G, 8, Mp] and Ms [G]
// int32 stack the models of padded width Mp; blk [nblocks, 3] int32 =
// (model, first, count) per block and order [.] int32 the window rows
// (BtItem); every block holds at most `per_block` windows, which must
// be the plan's.  The outputs, shaped as bt_fs3_domdec's over the whole
// batch, are written at the listed windows only.
extern "C" int bt_fs3_domdec_multi(const void* dsq, const void* lens, int B,
                                   int L, const void* etab, const void* ttab,
                                   const void* Ms, int erows, int Mp, int P,
                                   float nj, void* fspec, void* bspec,
                                   void* logz2, const void* blk,
                                   const void* order, int nblocks,
                                   int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = fs3_plan(B, Mp, P);
  if (per_block != l.G) return cudaErrorInvalidValue;
  return fs3_domdec_launch(l, nblocks, dsq, lens, B, L, etab, ttab, 0, Mp, P,
                           nj, fspec, bspec, logz2, erows, Ms, blk, order,
                           stream);
}
