// The fs3-Forward gate (F4): one score-only frameshift 3-codon Forward
// per DNA window, each under its own length model on L/3 (pmove =
// (2+nj)/(L/3+2+nj)), in probability space with every row rescaled by
// max(xE, 1).
//
// Replaces the TPU kernels bath_tpu/ops/pallas/fs3.py _fs3_kernel
// (fs3_score_pallas, Pallas #4), ops/pallas/fs3v2.py _fs3v2_kernel
// (fs3_score_v2, #5) and ops/pallas/fs3_sub.py _fs3sub_kernel
// (fs3_score_sub, #6), which compute the same score, and the production
// jnp gate ops/jaxk/fs3_v4.py _fs3_v4_impl.  It does not carry their
// dense M x M closure operators (W3, UT, U), which suit the MXU: the
// D->D chain is the per-thread affine-map scan of dp_common.cuh.  It
// stays in f32 (the jnp gate rounds emissions to bf16).
//
// What bounds it on the H100: each window is a latency chain of L
// dependent nucleotide rows (up to 2 * max_length * 3, three times an
// ORF's rows), each with one group-wide scan, and every row reads three
// codon rows of a 338 x Mp emission table that lives in L1/L2, not in
// shared memory.  The design answers with one warp per window for
// M <= 416 (P <= 13 lanes a thread), four windows to a block, the
// rings renamed rather than copied (fs3_common.cuh), and, past 416
// positions, several warps of 13 lanes per window.
//
// The multi-model entry bt_fs3_parser_multi replaces
// bath_tpu/ops/jaxk/multimodel.py fs3_pack_scores (build_fs3_pack):
// window b is scored under model slot[b].  It is this same kernel, item
// for item the same arithmetic; the TPU's lane packing (compact T2/T3/T4
// tables side by side, block-diagonal, a residue offset per slot) is not
// carried over.  The tables of the models of one padded width Mp are
// stacked [G, 338, Mp] and [G, 8, Mp]; a block finds its model and its
// windows in a per-block table (BtItem in dp_common.cuh) and stages that
// model's transitions in shared memory; one launch per Mp.  The bound is
// the single-model one, L dependent nucleotide rows per window.

#include "fs3_common.cuh"

template <int P>
__global__ void fs3_parser_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int B, int L,
                                  const float* __restrict__ etab,
                                  const float* __restrict__ ttab_g, int Mp,
                                  int W, float nj, float* __restrict__ out,
                                  int erows, const int* __restrict__ blk,
                                  const int* __restrict__ order) {
  extern __shared__ float smem[];
  const BtItem it = bt_item(blk, order, B, W);
  etab += (size_t)it.model * erows * Mp;
  const float *unused, *ttab;
  bt::load_tables(nullptr, ttab_g + (size_t)it.model * bt::NTR * Mp, 0, Mp,
                  smem, true, unused, ttab);
  const bt::Group g = bt_group(W, smem, (size_t)bt::NTR * Mp);
  const int b = it.b;
  if (b < 0) return;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)(len / 3) + 2.f + nj);
  double lsf;
  const double sc = bt::fs3_forward_pass<P, false>(
      g, etab, ttab, Mp, dsq + (size_t)b * L, len, pmove, nj, nullptr, 0, lsf);
  if (g.t == 0) out[b] = (float)sc;
}

// One launch of `blocks` blocks; blk/order null for a single model
// (erows, the emission rows of one model of a stack, is then unused).
static int fs3_launch(const BtLaunch& l, int blocks, const void* dsq,
                      const void* lens, int B, int L, const void* etab,
                      const void* ttab, int Mp, int P, float nj, void* out,
                      int erows, const void* blk, const void* order,
                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_FS3(PP)                                                    \
  {                                                                          \
    cudaFuncSetAttribute(fs3_parser_kernel<PP>,                              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    fs3_parser_kernel<PP><<<blocks, l.threads, l.smem, st>>>(                \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, Mp, l.W, nj, (float*)out, erows,                 \
        (const int*)blk, (const int*)order);                                 \
  }
  BT_DISPATCH_FS3_P(P, BT_LAUNCH_FS3)
#undef BT_LAUNCH_FS3
  return (int)cudaGetLastError();
}

// dsq [B, L] int8 nucleotides (pad 17); lens [B] int32; etab [338, Mp]
// packed codon odds and ttab [8, Mp] transitions, zero past the model;
// out [B] f32 nats.  Returns the launch's cudaError_t.
extern "C" int bt_fs3_parser(const void* dsq, const void* lens, int B, int L,
                             const void* etab, const void* ttab, int Mp,
                             int P, float nj, void* out, void* stream) {
  if (B <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = fs3_plan(B, Mp, P);
  return fs3_launch(l, l.blocks, dsq, lens, B, L, etab, ttab, Mp, P, nj, out,
                    0, nullptr, nullptr, stream);
}

// The multi-model entry: etab [G, erows, Mp] and ttab [G, 8, Mp] stack
// the tables of the models of padded width Mp; blk [nblocks, 3] int32 =
// (model, first, count) per block and order [.] int32 the window rows
// (BtItem); every block holds at most `per_block` windows, which must
// be the plan's.  out [B] is written at the listed windows only.
extern "C" int bt_fs3_parser_multi(const void* dsq, const void* lens, int B,
                                   int L, const void* etab, const void* ttab,
                                   int erows, int Mp, int P, float nj,
                                   void* out, const void* blk,
                                   const void* order, int nblocks,
                                   int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = fs3_plan(B, Mp, P);
  if (per_block != l.G) return cudaErrorInvalidValue;
  return fs3_launch(l, nblocks, dsq, lens, B, L, etab, ttab, Mp, P, nj, out,
                    erows, blk, order, stream);
}
