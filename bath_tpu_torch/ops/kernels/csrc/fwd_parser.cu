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

#include "dp_common.cuh"

template <int P>
__global__ void fwd_parser_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int B, int L,
                                  const float* __restrict__ etab_g,
                                  const float* __restrict__ ttab_g, int Kp,
                                  int Mp, int W, bool tab_in_smem, float nj,
                                  float* __restrict__ out) {
  extern __shared__ float smem[];
  const float *etab, *ttab;
  bt::load_tables(etab_g, ttab_g, Kp, Mp, smem, tab_in_smem, etab, ttab);
  const size_t tab_floats = tab_in_smem ? (size_t)(Kp + bt::NTR) * Mp : 0;
  const bt::Group g = bt_group(W, smem, tab_floats);
  const int G = blockDim.x / (32 * W);
  const int b = blockIdx.x * G + (threadIdx.x >> 5) / W;
  if (b >= B) return;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)len + 2.f + nj);
  double lsf;
  const double sc = bt::forward_pass<P, false>(
      g, etab, ttab, Mp, dsq + (size_t)b * L, len, pmove, nj, nullptr, 0, lsf);
  if (g.t == 0) out[b] = (float)sc;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_FWD(PP)                                                    \
  {                                                                          \
    cudaFuncSetAttribute(fwd_parser_kernel<PP>,                              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    fwd_parser_kernel<PP><<<l.blocks, l.threads, l.smem, st>>>(              \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, Kp, Mp, l.W, l.tab_in_smem, nj, (float*)out);    \
  }
  BT_DISPATCH_P(P, BT_LAUNCH_FWD)
#undef BT_LAUNCH_FWD
  return (int)cudaGetLastError();
}
