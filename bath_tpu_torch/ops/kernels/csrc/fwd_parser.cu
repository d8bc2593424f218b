// The Forward-parser gate (F3): one score-only amino Forward per ORF,
// each under its own length model (pmove = (2+nj)/(L+2+nj)), in
// probability space with every row rescaled by max(xE, 1).
//
// Replaces the TPU kernel bath_tpu/ops/pallas/fwd.py _fwd_kernel
// (fwd_score_pallas) and its production jnp twin
// bath_tpu/ops/jaxk/kernels.py _fwd_mb_impl.  Unlike the latter it
// stays in f32 (no bf16 emission rounding).  It also replaces
// bath_tpu/ops/jaxk/multimodel.py fwd_pack_scores (build_fwd_pack):
// item b scored under model slot[b]; the TPU's lane packing (G models
// side by side in blocks of Mg lanes, a block-diagonal emission table,
// stacked [G, Mg, Mg] closures) is not carried over.  One entry serves
// the single-model calls (#1) and the multi-model ones (J3a, J4c): a
// single model is a plan of one class.
//
// What bounds it on the H100: each ORF is a latency chain of L
// dependent rows, and every row needs one group-wide sum (xE) and one
// group-wide scan (D->D); the work per row is only ~10 flops per model
// lane.  The gate is decoding's Forward pass without its stores
// (dp_common.cuh forward_pass<P, false>), on decoding's plan
// (plan.cuh; ops/multimodel.py fwd_plan):
// - One launch for every padded width of a call, blocks heaviest first
//   (Mp x longest ORF), so a call takes about its heaviest chain and
//   not the sum over its widths.
// - A block holds G groups of W warps, one ORF a group, all of one
//   model, whose f32 tables it stages in shared memory where they fit
//   (up to the 227 KB a block may take: every class to Mp = 1056); a
//   wider class stages its transitions only and reads its odds from L2
//   (the class row's stage word).
// - Groups of W > 1 warps sync on a named barrier of their own, so
//   several share a block and its copy of the tables.
// - A batch of fewer items than four an SM gets blocks of fewer groups,
//   spread over the SMs.
// - A single-model call (#1: a cascade batch of up to 4096 ORFs, already
//   sorted by length) builds no per-item plan: its one class has no
//   block rows, and block x takes the items x*G .. x*G+G-1 in batch
//   order.
// - The kernel is instantiated for the largest P of the launch (13, 17
//   or 33), so a call of narrow models pays no wide model's registers,
//   and for what every class of the launch stages (both tables, its
//   transitions, or not even those), so that the tables a launch
//   stages are read as shared memory (32-bit addresses, fewer
//   registers).  A block of more warps than the instance's
//   registers let launch (asked of the card once an instance) takes a
//   wide instance capped at 64 registers a thread; a group takes at
//   most a block's 32 warps (loader.fwd_layout: M = 33792).
// - A longer model takes a group of 16 warps that walks each row in S
//   segments (dp_common.cuh forward_pass_seg), in an instance of its own
//   (blocks of 512 threads, 128 registers a thread), which takes the
//   launch's other classes too; beside a class of more than 16 warps, the
//   same code capped as the wide instance.

#include "dp_common.cuh"

__host__ __device__ constexpr int fwd_instance(int pmax) {
  return pmax <= 13 ? 13 : pmax <= 17 ? 17 : 33;
}

// The class row of the plan (plan.cuh): the addresses of the class's
// stacked tables etab [g][Kp][Mp] and ttab [g][8][Mp] f32, P, W, Mp, G,
// Kp, where a block keeps the tables (bt::Stage), the segments S and a
// segmented class's scratch.  The items are the batch rows b.  With
// nblk == 0 the plan is one class and no block rows: block x's groups
// take the items x*G + gi under model 0.  SM: every class of the launch
// stages both tables (2), its transitions at least (1), or not even
// those (0).  SEG: the instance of a launch with a segmented class.
template <int PMAX, int SM, bool SEG = false>
__device__ __forceinline__ void fwd_parser_block(
    const int8_t* __restrict__ dsq, const int* __restrict__ lens, int B,
    int L, float nj, float* __restrict__ out,
    const long long* __restrict__ plan, int ncls, int nblk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  PlanBlock pb;
  if (nblk > 0) {
    pb = plan_block(plan, ncls, nblk);
  } else {
    const int W = (int)plan[3], G = (int)plan[5];
    pb.cls = plan;
    pb.model = 0;
    pb.gi = (threadIdx.x >> 5) / W;
    const int b = blockIdx.x * G + pb.gi;
    pb.item = pb.gi < G && b < B ? b : -1;
  }
  const long long* c = pb.cls;
  const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], Kp = (int)c[6];
  const int stage = (int)c[7];
  const float *etab, *ttab;
  bt::load_tables(
      reinterpret_cast<const float*>(c[0]) + (size_t)pb.model * Kp * Mp,
      reinterpret_cast<const float*>(c[1]) + (size_t)pb.model * bt::NTR * Mp,
      Kp, Mp, smem, stage, etab, ttab);
  if (SM == 2) etab = smem;
  if (SM >= 1) ttab = smem + (stage == bt::STAGE_ALL ? Kp * Mp : 0);
  if (pb.item < 0) return;
  const size_t at = bt::staged_bytes(Kp, Mp, stage) +
                    pb.gi * bt::group_bytes(W);
  bt::Group g = bt_group(W, smem, at / sizeof(float));
  g.bar = 1 + pb.gi;
  const int b = pb.item;
  const int len = lens[b];
  const float pmove = (2.f + nj) / ((float)len + 2.f + nj);
  const int8_t* seq = dsq + (size_t)b * L;
  double lsf, sc = 0.0;
  const int S = SEG ? (int)c[8] : 1;
  // a segmented class: one group a block, which takes a slot of the
  // class's scratch, its carries past the group's scratch
  float* cx = reinterpret_cast<float*>(g.x.agg) + 8 * W;
  float* slot = nullptr;
  int sid = 0;
  if (SEG && S > 1)
    slot = reinterpret_cast<float*>(seg_take(
        c, bt::dp_seg_slot_bytes(Mp), reinterpret_cast<int*>(cx), sid));
#define BT_GATE(PP)                                                          \
  if constexpr (PP <= PMAX) {                                                \
    if (SEG && S > 1)                                                        \
      sc = bt::forward_pass_seg<PP, false>(g, etab, ttab, Mp, S, seq, len,   \
                                           pmove, nj, nullptr, 0, lsf, slot, \
                                           cx);                              \
    else                                                                     \
      sc = bt::forward_pass<PP, false>(g, etab, ttab, Mp, seq, len, pmove,   \
                                       nj, nullptr, 0, lsf);                 \
  }                                                                          \
  break;
  switch (P) {  // the plan's classes are checked on the host (bt_plan_check)
    case 3: BT_GATE(3)
    case 5: BT_GATE(5)
    case 9: BT_GATE(9)
    case 13: BT_GATE(13)
    case 17: BT_GATE(17)
    case 25: BT_GATE(25)
    case 33: BT_GATE(33)
  }
#undef BT_GATE
  if (g.t == 0) out[b] = (float)sc;
  if (SEG && S > 1) seg_free(c, sid);
}

#define FWD_ARGS                                                          \
  const int8_t *__restrict__ dsq, const int *__restrict__ lens, int B,    \
      int L, float nj, float *__restrict__ out,                           \
      const long long *__restrict__ plan, int ncls, int nblk

template <int PMAX, int SM>
__global__ void fwd_parser_kernel(FWD_ARGS) {
  fwd_parser_block<PMAX, SM>(dsq, lens, B, L, nj, out, plan, ncls, nblk);
}

// A block of more warps than an instance's registers let launch (a
// class of many warps an ORF; up to 32): every P, the tables read
// through generic addresses, at most 64 registers a thread.
__global__ void __launch_bounds__(1024) fwd_parser_wide_kernel(FWD_ARGS) {
  fwd_parser_block<33, 0>(dsq, lens, B, L, nj, out, plan, ncls, nblk);
}

// A launch with a segmented class (a model past 32 warps of 33 lanes):
// blocks of its group's 16 warps (the plan segments any class of more
// warps beside it).
__global__ void __launch_bounds__(512) fwd_parser_seg_kernel(FWD_ARGS) {
  fwd_parser_block<33, 0, true>(dsq, lens, B, L, nj, out, plan, ncls, nblk);
}
#undef FWD_ARGS

using FwdKernel = void (*)(const int8_t*, const int*, int, int, float,
                           float*, const long long*, int, int);

// The most threads a block of the instance may have on the current
// device (its registers), asked once an instance and device.
template <int PMAX, int SM>
static int fwd_max_threads() {
  static int most[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& m = most[dev & 63];
  if (!m) {
    cudaFuncAttributes a;
    m = cudaFuncGetAttributes(&a, fwd_parser_kernel<PMAX, SM>) == cudaSuccess
            ? a.maxThreadsPerBlock
            : -1;
  }
  return m;
}

// The instance for the launch's largest P and staging, or the wide one
// where a block of <warps> warps would not launch.
template <int PMAX, int SM>
static FwdKernel fwd_pick(int warps) {
  return 32 * warps <= fwd_max_threads<PMAX, SM>()
             ? fwd_parser_kernel<PMAX, SM>
             : fwd_parser_wide_kernel;
}

// dsq [B, L] int8 residues; lens [B] int32; out [B] f32 nats, written at
// the plan's items.  plan_host and plan: the plan's table (plan.cuh, the
// class row above) on the host and on the device, with ncls classes and
// nblk blocks of `warps` warps; nblk == 0 for one class over all B items
// in batch order (a single-model call).  Returns the launch's
// cudaError_t.
extern "C" int bt_fwd_parser(const void* dsq, const void* lens, int B, int L,
                             float nj, void* out, const long long* plan_host,
                             const void* plan, int ncls, int nblk, int warps,
                             void* stream) {
  if (B <= 0) return 0;
  if (nblk == 0 && ncls != 1) return cudaErrorInvalidValue;
  int pmax;
  bool seg;
  size_t smem;
  const int err = bt_plan_check(plan_host, ncls, warps, pmax, seg, smem);
  if (err) return err;
  if (seg && nblk == 0) return cudaErrorInvalidValue;
  const int G = (int)plan_host[5];
  const int grid = nblk > 0 ? nblk : (B + G - 1) / G;
  int sm = 2;
  for (int i = 0; i < ncls; ++i) {
    const long long stage = plan_host[PLAN_CLS * i + 7];
    sm = stage == bt::STAGE_NONE ? 0 : stage == bt::STAGE_TRANS && sm ? 1 : sm;
  }
  const int inst = fwd_instance(pmax);
  // a class stages nothing past ~7000 lanes (P = 17 or 33), so no
  // P = 13 instance stages nothing
  const FwdKernel k =
      seg          ? fwd_parser_seg_kernel
      : inst == 13 ? (sm == 2   ? fwd_pick<13, 2>(warps)
                    : sm == 1 ? fwd_pick<13, 1>(warps)
                              : fwd_parser_wide_kernel)
      : inst == 17 ? (sm == 2   ? fwd_pick<17, 2>(warps)
                      : sm == 1 ? fwd_pick<17, 1>(warps)
                                : fwd_pick<17, 0>(warps))
                   : (sm == 2   ? fwd_pick<33, 2>(warps)
                      : sm == 1 ? fwd_pick<33, 1>(warps)
                                : fwd_pick<33, 0>(warps));
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  k<<<grid, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)dsq, (const int*)lens, B, L, nj, (float*)out,
      (const long long*)plan, ncls, nblk);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_fwd_parser_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(bt::dp_seg_slot_bytes(Mp), n);
}
