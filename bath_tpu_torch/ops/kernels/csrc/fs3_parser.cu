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
// stays in f32 (the jnp gate rounds emissions to bf16).  It also
// replaces bath_tpu/ops/jaxk/multimodel.py fs3_pack_scores
// (build_fs3_pack), window b under model slot[b]; the TPU's lane
// packing (compact T2/T3/T4 tables side by side, block-diagonal, a
// residue offset per slot) is not carried over.
//
// What bounds it on the H100: each window is a latency chain of L
// dependent nucleotide rows (up to 2 * max_length * 3, three times an
// ORF's rows), each with one group-wide scan, and every row reads three
// codon rows of a 338 x Mp emission table too large for shared memory
// (0.5 MB at M = 400).  The design: one warp per window for M <= 416 (P <= 13
// lanes a thread) and several warps of 13 lanes past that, the rings
// renamed rather than copied, the codon rows fetched a row ahead into
// shared memory by the copy engine (fs3_common.cuh); one launch for every
// padded width of a batch (the plan of fs3_common.cuh: a block runs its
// class's P and holds as many windows of one model as fit), its blocks
// longest window first, so a batch takes about the time of its longest
// chain and not the sum over its widths.
//
// One entry serves the single-model and the multi-model calls: a single
// model is a plan of one class and one model.  A model past 32 warps of
// 13 lanes walks each row in segments (fs3_forward_pass_seg), in an
// instance of its own (MODE 4).

#include "fs3_common.cuh"

namespace bt {

template <int P, bool DIRECT, bool SEG = false>
__device__ void fs3_gate(const Fs3Slot& s, const int8_t* __restrict__ dsq,
                         const int* __restrict__ lens, int L, float nj,
                         float* __restrict__ out) {
  const int len = lens[s.b];
  const float pmove = (2.f + nj) / ((float)(len / 3) + 2.f + nj);
  double lsf, sc;
  if constexpr (SEG) {
    if (s.S > 1) {
      sc = fs3_forward_pass_seg<P, false>(s.g, s.ring, s.ttab, s.Mp, s.S,
                                          dsq + (size_t)s.b * L, len, pmove,
                                          nj, nullptr, 0, lsf, s.slot, s.cx);
      if (s.g.t == 0) out[s.b] = (float)sc;
      return;
    }
  }
  sc = fs3_forward_pass<P, false, DIRECT>(s.g, s.ring, s.ttab, s.Mp,
                                          dsq + (size_t)s.b * L, len, pmove,
                                          nj, nullptr, 0, lsf);
  if (s.g.t == 0) out[s.b] = (float)sc;
}

}  // namespace bt

template <int MODE>
__device__ __forceinline__ void fs3_parser_block(
    const int8_t* __restrict__ dsq, const int* __restrict__ lens, int L,
    float nj, float* __restrict__ out, const long long* __restrict__ plan,
    int ncls, int nblk) {
  extern __shared__ float4 smem4[];
  const bt::Fs3Slot s = bt::fs3_slot<MODE>(plan, ncls, nblk, 1,
                                           reinterpret_cast<char*>(smem4));
  if (s.b < 0) return;
#define BT_FS3_GATE(PP) \
  bt::fs3_gate<PP, (MODE >= 1), (MODE >= 4)>(s, dsq, lens, L, nj, out)
  BT_FS3_DISPATCH(s.P, BT_FS3_GATE)
#undef BT_FS3_GATE
  if (MODE >= 4 && s.S > 1) seg_free(s.cls, s.sid);
}

// The ring and direct instances (MODE 0, 1) take the registers they
// need; the others are capped for blocks of 16 or 32 warps.
template <int MODE>
__global__ void fs3_parser_kernel(const int8_t* __restrict__ dsq,
                                  const int* __restrict__ lens, int L,
                                  float nj, float* __restrict__ out,
                                  const long long* __restrict__ plan,
                                  int ncls, int nblk) {
  fs3_parser_block<MODE>(dsq, lens, L, nj, out, plan, ncls, nblk);
}

template <int MODE>
__global__ void __launch_bounds__(fs3_threads(MODE))
    fs3_parser_wide_kernel(const int8_t* __restrict__ dsq,
                           const int* __restrict__ lens, int L, float nj,
                           float* __restrict__ out,
                           const long long* __restrict__ plan, int ncls,
                           int nblk) {
  fs3_parser_block<MODE>(dsq, lens, L, nj, out, plan, ncls, nblk);
}

// dsq [B, L] int8 nucleotides (pad 17); lens [B] int32; out [B] f32
// nats, written at the plan's windows.  plan_host and plan: the plan's
// table (fs3_common.cuh) on the host and on the device, with ncls
// classes and nblk blocks of `warps` warps.  Returns the launch's
// cudaError_t.
extern "C" int bt_fs3_parser(const void* dsq, const void* lens, int L,
                             float nj, void* out, const long long* plan_host,
                             const void* plan, int ncls, int nblk, int warps,
                             void* stream) {
  if (nblk <= 0) return 0;
  size_t smem;
  const int err = fs3_check(plan_host, ncls, warps, smem);
  if (err) return err;
  const int mode = fs3_mode(plan_host, ncls, warps);
  auto kernel = mode == 0   ? fs3_parser_kernel<0>
                : mode == 1 ? fs3_parser_kernel<1>
                : mode == 2 ? fs3_parser_wide_kernel<2>
                : mode == 3 ? fs3_parser_wide_kernel<3>
                            : fs3_parser_wide_kernel<4>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<nblk, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)dsq, (const int*)lens, L, nj, (float*)out,
      (const long long*)plan, ncls, nblk);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_fs3_parser_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(bt::fs3_seg_slot_bytes(1, Mp), n);
}
