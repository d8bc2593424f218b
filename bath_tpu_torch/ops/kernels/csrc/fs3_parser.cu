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

#include "fs3_common.cuh"

template <int P>
__global__ void fs3_parser_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int B, int L,
                                  const float* __restrict__ etab,
                                  const float* __restrict__ ttab_g, int Mp,
                                  int W, float nj, float* __restrict__ out) {
  extern __shared__ float smem[];
  const float *unused, *ttab;
  bt::load_tables(nullptr, ttab_g, 0, Mp, smem, true, unused, ttab);
  const bt::Group g = bt_group(W, smem, (size_t)bt::NTR * Mp);
  const int G = blockDim.x / (32 * W);
  const int b = blockIdx.x * G + (threadIdx.x >> 5) / W;
  if (b >= B) return;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)(len / 3) + 2.f + nj);
  double lsf;
  const double sc = bt::fs3_forward_pass<P, false>(
      g, etab, ttab, Mp, dsq + (size_t)b * L, len, pmove, nj, nullptr, 0, lsf);
  if (g.t == 0) out[b] = (float)sc;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define BT_LAUNCH_FS3(PP)                                                    \
  {                                                                          \
    cudaFuncSetAttribute(fs3_parser_kernel<PP>,                              \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                         (int)l.smem);                                       \
    fs3_parser_kernel<PP><<<l.blocks, l.threads, l.smem, st>>>(              \
        (const int8_t*)dsq, (const int*)lens, B, L, (const float*)etab,      \
        (const float*)ttab, Mp, l.W, nj, (float*)out);                       \
  }
  BT_DISPATCH_FS3_P(P, BT_LAUNCH_FS3)
#undef BT_LAUNCH_FS3
  return (int)cudaGetLastError();
}
