// The Forward-parser gate (F3): one score-only amino Forward per ORF,
// each under its own length model (pmove = (2+nj)/(L+2+nj)), in
// probability space with every row rescaled by max(xE, 1).
//
// Replaces the TPU kernel bath_tpu/ops/pallas/fwd.py _fwd_kernel
// (fwd_score_pallas) and its production jnp twin
// bath_tpu/ops/jaxk/kernels.py _fwd_mb_impl.  Unlike the latter it
// stays in f32 (no bf16 emission rounding).
//
// What bounds it on the H100: each ORF is a latency chain of L
// dependent rows, and every row needs one group-wide sum (xE) and one
// group-wide scan (D->D); the work per row is only ~10 flops per model
// lane.  The design answers with many ORFs in flight: one warp per ORF
// for models up to 1056 positions, eight ORFs to a block sharing one
// copy of the emission/transition tables in shared memory, so an SM
// interleaves dozens of independent chains and the shuffle-only scan
// never waits on a block barrier.
//
// The multi-model entry bt_fwd_parser_multi replaces
// bath_tpu/ops/jaxk/multimodel.py fwd_pack_scores (build_fwd_pack): item
// b is scored under model slot[b].  It is this same kernel, and so the
// same arithmetic, item for item: the TPU's lane packing (G models side
// by side in blocks of Mg lanes, a block-diagonal emission table, stacked
// [G, Mg, Mg] closures) is not carried over.  The tables of the models
// of one padded width Mp are stacked [G, Kp, Mp] and [G, 8, Mp], and a
// block finds its model and its items in a per-block table (BtItem in
// dp_common.cuh); one launch per Mp.  The same bound holds: a latency
// chain per ORF; batching across models only adds independent chains.

#include "dp_common.cuh"

template <int P>
__global__ void fwd_parser_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int B, int L,
                                  const float* __restrict__ etab_g,
                                  const float* __restrict__ ttab_g, int Kp,
                                  int Mp, int W, bool tab_in_smem, float nj,
                                  float* __restrict__ out,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ order) {
  extern __shared__ float smem[];
  const BtItem it = bt_item(blk, order, B, W);
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
  double lsf;
  const double sc = bt::forward_pass<P, false>(
      g, etab, ttab, Mp, dsq + (size_t)b * L, len, pmove, nj, nullptr, 0, lsf);
  if (g.t == 0) out[b] = (float)sc;
}

// One launch of `blocks` blocks; blk/order null for a single model.
static int fwd_launch(const BtLaunch& l, int blocks, const void* dsq,
                      const void* lens, int B, int L, const void* etab,
                      const void* ttab, int Kp, int Mp, int P, float nj,
                      void* out, const void* blk, const void* order,
                      void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_FWD(PP)                                                    \
  {                                                                          \
    cudaFuncSetAttribute(fwd_parser_kernel<PP>,                              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    fwd_parser_kernel<PP><<<blocks, l.threads, l.smem, st>>>(                \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, Kp, Mp, l.W, l.tab_in_smem, nj, (float*)out,     \
        (const int*)blk, (const int*)order);                                 \
  }
  BT_DISPATCH_P(P, BT_LAUNCH_FWD)
#undef BT_LAUNCH_FWD
  return (int)cudaGetLastError();
}

// dsq [B, L] int8 residues; lens [B] int32; etab [Kp, Mp] odds and
// ttab [8, Mp] transitions, zero past the model; out [B] f32 nats.
// Returns the launch's cudaError_t.
extern "C" int bt_fwd_parser(const void* dsq, const void* lens, int B, int L,
                             const void* etab, const void* ttab, int Kp,
                             int Mp, int P, float nj, void* out,
                             void* stream) {
  if (B <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = bt_plan(B, Kp, Mp, P, 100 * 1024);
  return fwd_launch(l, l.blocks, dsq, lens, B, L, etab, ttab, Kp, Mp, P, nj,
                    out, nullptr, nullptr, stream);
}

// The multi-model entry: etab [G, Kp, Mp] and ttab [G, 8, Mp] stack the
// tables of the models of padded width Mp; blk [nblocks, 3] int32 =
// (model, first, count) per block and order [.] int32 the item rows
// (BtItem); every block holds at most `per_block` items, which must be
// the plan's.  out [B] is written at the listed items only.
extern "C" int bt_fwd_parser_multi(const void* dsq, const void* lens, int B,
                                   int L, const void* etab, const void* ttab,
                                   int Kp, int Mp, int P, float nj, void* out,
                                   const void* blk, const void* order,
                                   int nblocks, int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (Mp % (32 * P) != 0) return cudaErrorInvalidValue;
  const BtLaunch l = bt_plan(B, Kp, Mp, P, 100 * 1024);
  if (per_block != l.G) return cudaErrorInvalidValue;
  return fwd_launch(l, nblocks, dsq, lens, B, L, etab, ttab, Kp, Mp, P, nj,
                    out, blk, order, stream);
}
