// The MSV filter (F1) with its SSV pre-pass, fused: per ORF, the SSV
// pass's int8 saturating diagonals and their running unsigned byte max
// (xEu), and the MSV pass's uint8 cells with the xB/xJ specials (xJ and
// the overflow flag).  The uint16-wraparound post-processing that picks
// the SSV or the MSV score runs after it (ops/ssv.py msv_post).
//
// Replaces the TPU kernel bath_tpu/ops/pallas/ssv.py _ssv_kernel
// (ssv_xe_pallas, Pallas #2) and the production jnp kernels
// bath_tpu/ops/jaxk/filters_mb.py _ssv_msv_mb_impl and
// _ssv_msv_stream_impl.  It reads each ORF at its offset in the flush's
// one residue stream, so it needs neither their length buckets nor the
// stream packing that worked around per-launch TPU latency.  Its
// maxima cover the M real model lanes only (Pallas #2 lets its
// 128-lane padding into xEu).  It also replaces the MSV half of
// bath_tpu/evalues_device.py _dyn_kernels (the vmap of _ssv_msv_mb_impl
// over models with base/tec/tbm/bias as traced values): item b under
// model slot[b].  One entry serves both: a single model is a class of
// one.
//
// What bounds it on the H100: a flush is ~65k short ORFs (mean ~40
// residues), a calibration 48 x 200 equal ones of 200; each a chain of
// dependent rows of ~10 byte operations per model lane and one
// group-wide max (xE feeds the next row's xB).  Such calls are
// throughput-bound: integer issue and the row latency.  The design:
// - Each lane's table word is an int16 (the SSV byte in bits 0-7, the
//   MSV cost in bits 8-15; ops/ssv.py MSVParams.table), stored
//   warp-transposed (int_common.cuh lane_at) so that a warp reads 32
//   neighbouring halfwords, and a block stages its model's table in
//   shared memory once: 29 x Mp x 2 bytes, 221 KB at Mp = 3808 (seven
//   warps of 17 lanes, loader.msv_layout).  A longer model reads its
//   table from L2 (the class row's stage word).
// - A multi-model call is one launch for every padded width (plan.cuh;
//   ops/multimodel.py msv_plan): blocks heaviest first (Mp x longest
//   item), G groups of W warps a block, one ORF a group, all of one
//   model; groups of W > 1 warps sync on a named barrier of their own.
// - A single-model call (a flush) builds no per-item plan: its one class
//   has no block rows, and the blocks stride over the items in batch
//   order, as many as the card holds at once.
// - The kernel is instantiated for the largest P of the launch (13 or
//   33; and 33 with 32-warp blocks for a model past 12 warps an ORF),
//   and apart for a launch with a class whose table stays in global
//   memory, so that every other launch reads its tables as shared
//   memory (32-bit addresses, fewer registers).
// - A model past a block of 32 warps of 33 lanes is segmented (int_common
//   .cuh): its group of 16 warps walks each row in S segments, a lane's
//   two bytes waiting in the block's slot of the class's scratch between
//   them (plan.cuh seg_take), in an instance of its own (blocks of 16
//   warps; the plan segments any class of more beside it), which also
//   takes the launch's other classes.

#include "int_common.cuh"
#include "int_plan.cuh"

namespace bi {

// One ORF b under one model, on the group <g>.  <ew>: the table words
// at this thread's lane 0 (lane j at +32j; row r at +r*Mp).
template <int P>
__device__ void msv_item(const Group& g, const uint16_t* ew, int Mp, int M,
                         int base, int tec, int tbm, int bias, int b, int B,
                         const int8_t* __restrict__ flat,
                         const int64_t* __restrict__ offs,
                         const int* __restrict__ lens,
                         const int* __restrict__ tjb, int* __restrict__ out) {
  const int k0 = g.t * P;
  const int len = lens[b];
  const int tjbm = (tjb[b] + tbm) & 0xFF;
  const int8_t* seq = flat + offs[b];
  int d[P], dp[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    d[j] = -128;
    dp[j] = 0;
  }
  int umax = 0, xJ = 0, movf = 0;
  int xB = max(0, base - tjbm);
  for (int i = 0; i < len; ++i) {
    const uint16_t* e = ew + (int)seq[i] * Mp;
    // the previous row's SSV and MSV cells at lane k0-1, in one word
    const int pv =
        lane_before(g, (d[P - 1] & 0xFF) | (dp[P - 1] << 8), 0x80);
    const int dprev = ((pv & 0xFF) ^ 0x80) - 0x80;
    const int mprev = pv >> 8;
    int xE = 0;
    // in place, high lane first: lane j reads lane j-1's old cells
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const int ent = e[32 * j];
      const int s = ((ent & 0xFF) ^ 0x80) - 0x80;
      const int r = ent >> 8;
      const int nd = min(max((j ? d[j - 1] : dprev) - s, -128), 127);
      int sv = max(j ? dp[j - 1] : mprev, xB);
      sv = max(min(sv + bias, 255) - r, 0);
      d[j] = nd;
      dp[j] = sv;
      if (k0 + j < M) {
        umax = max(umax, nd & 0xFF);
        xE = max(xE, sv);
      }
    }
    xE = group_max(g, xE);
    movf |= xE + bias >= 255;
    xJ = max(xJ, max(0, xE - tec));
    xB = max(0, max(base, xJ) - tjbm);
  }
  umax = group_max(g, umax);
  if (g.t == 0) {
    out[b] = umax;
    out[B + b] = xJ;
    out[2 * B + b] = movf;
  }
}

// msv_item for a segmented group: each row in S segments of 32 W P
// lanes; between them a lane's SSV and MSV bytes wait in one uint16 word
// of <slot> (segment s, lane j of thread t at (s P + j) 32 W + t).  The
// row's maximum (xE) is taken once, after the last segment.  <tab>: the
// table words of lane 0.
template <int P>
__device__ void msv_item_seg(const Group& g, const uint16_t* tab, int Mp,
                             int M, int S, int base, int tec, int tbm,
                             int bias, int b, int B,
                             const int8_t* __restrict__ flat,
                             const int64_t* __restrict__ offs,
                             const int* __restrict__ lens,
                             const int* __restrict__ tjb,
                             int* __restrict__ out, uint16_t* slot, int* cx) {
  const int NT = 32 * g.W, SEG = NT * P;
  const int len = lens[b];
  const int tjbm = (tjb[b] + tbm) & 0xFF;
  const int8_t* seq = flat + offs[b];
  int umax = 0, xJ = 0, movf = 0;
  int xB = max(0, base - tjbm);
  for (int i = 0; i < len; ++i) {
    const int res = (int)seq[i];
    int xE = 0;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      const uint16_t* e =
          tab + (size_t)res * Mp + (s * g.W + g.warp) * 32 * P + g.lane;
      uint16_t* st = slot + (size_t)s * SEG + g.t;
      int d[P], dp[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int w = i ? (int)st[j * NT] : 0x0080;
        d[j] = ((w & 0xFF) ^ 0x80) - 0x80;
        dp[j] = w >> 8;
      }
      int pv, u1, u2;
      lane_before_seg(g, (d[P - 1] & 0xFF) | (dp[P - 1] << 8), 0, 0, 0x80, s,
                      cx, pv, u1, u2);
      const int dprev = ((pv & 0xFF) ^ 0x80) - 0x80;
      const int mprev = pv >> 8;
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int ent = e[32 * j];
        const int sb = ((ent & 0xFF) ^ 0x80) - 0x80;
        const int r = ent >> 8;
        const int nd = min(max((j ? d[j - 1] : dprev) - sb, -128), 127);
        int sv = max(j ? dp[j - 1] : mprev, xB);
        sv = max(min(sv + bias, 255) - r, 0);
        d[j] = nd;
        dp[j] = sv;
        if (k0 + j < M) {
          umax = max(umax, nd & 0xFF);
          xE = max(xE, sv);
        }
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        st[j * NT] = (uint16_t)((d[j] & 0xFF) | (dp[j] << 8));
    }
    xE = group_max(g, xE);
    movf |= xE + bias >= 255;
    xJ = max(xJ, max(0, xE - tec));
    xB = max(0, max(base, xJ) - tjbm);
  }
  umax = group_max(g, umax);
  if (g.t == 0) {
    out[b] = umax;
    out[B + b] = xJ;
    out[2 * B + b] = movf;
  }
}

}  // namespace bi

// The class row of the plan (plan.cuh): the address of the class's
// stacked tables [g][Kp][Mp] int16 (warp-transposed), the address of its
// scalars [g][5] int (M, base, tec, tbm, bias), P, W, Mp, G, Kp,
// whether a block stages the table in shared memory (every class of the
// launch does unless GLOBAL), the segments S and the address of a
// segmented class's scratch (SEG).  With nblk == 0 the plan is one class
// and no block rows: block x's groups take the items x*G + gi, stepping
// by the grid's groups, under model 0.
template <int PMAX, int WARPS, bool GLOBAL, bool SEG = false>
__global__ void __launch_bounds__(32 * WARPS)
    msv_filter_kernel(const int8_t* __restrict__ flat,
                      const int64_t* __restrict__ offs,
                      const int* __restrict__ lens,
                      const int* __restrict__ tjb, int B,
                      int* __restrict__ out,
                      const long long* __restrict__ plan, int ncls,
                      int nblk) {
  extern __shared__ int4 smem4[];
  const long long* c = plan;
  int model = 0, first, end, step;
  const int W0 = (int)plan[3];
  int gi = (threadIdx.x >> 5) / W0;
  if (nblk > 0) {
    const PlanBlock pb = plan_block(plan, ncls, nblk);
    c = pb.cls;
    model = pb.model;
    gi = pb.gi;
    first = pb.first + gi;
    end = pb.first + pb.count;
    step = (int)c[5];
  } else {
    const int G = (int)c[5];
    first = blockIdx.x * G + gi;
    end = B;
    step = gridDim.x * G;
  }
  const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], G = (int)c[5];
  const int Kp = (int)c[6];
  const bool staged = !GLOBAL || c[7] != 0;
  const uint16_t* tg = reinterpret_cast<const uint16_t*>(c[0]) +
                       (size_t)model * Kp * Mp;
  const int* s = reinterpret_cast<const int*>(c[1]) + 5 * model;
  const size_t tab_bytes = (size_t)Kp * Mp * sizeof(uint16_t);
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem4);
  if (staged)
    bi::stage_words(tg, tab_bytes, smem4);
  else
    tab = tg;
  if (gi >= G) return;
  bi::Group g = bi::make_group(
      W, reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                (staged ? tab_bytes : 0)) +
             4 * W * gi);
  g.bar = 1 + gi;
  const uint16_t* ew = tab + g.warp * 32 * P + g.lane;
  const int M = s[0], base = s[1], tec = s[2], tbm = s[3], bias = s[4];
  const long long* items = plan + PLAN_CLS * ncls + PLAN_BLK * nblk;
  const int S = SEG ? (int)c[8] : 1;
  // a segmented class: one group a block, which takes a slot of the
  // class's scratch, its carry past the group's scratch
  int* cx = g.x + 4 * W;
  uint16_t* slot = nullptr;
  int sid = 0;
  if (SEG && S > 1)
    slot = reinterpret_cast<uint16_t*>(
        seg_take(c, msv_seg_slot_bytes(Mp), cx, sid));
#define BI_MSV_ITEMS(PP)                                                  \
  if constexpr (PP <= PMAX) {                                             \
    if (SEG && S > 1)                                                     \
      bi::msv_item_seg<PP>(g, tab, Mp, M, S, base, tec, tbm, bias,        \
                           (int)items[first], B, flat, offs, lens, tjb,   \
                           out, slot, cx);                                \
    else                                                                  \
      for (int q = first; q < end; q += step)                             \
        bi::msv_item<PP>(g, ew, Mp, M, base, tec, tbm, bias,              \
                         nblk > 0 ? (int)items[q] : q, B, flat, offs,     \
                         lens, tjb, out);                                 \
  }                                                                       \
  break;
  switch (P) {  // the plan's classes are checked on the host (msv_check)
    case 3: BI_MSV_ITEMS(3)
    case 5: BI_MSV_ITEMS(5)
    case 9: BI_MSV_ITEMS(9)
    case 13: BI_MSV_ITEMS(13)
    case 17: BI_MSV_ITEMS(17)
    case 25: BI_MSV_ITEMS(25)
    case 33: BI_MSV_ITEMS(33)
  }
#undef BI_MSV_ITEMS
  if (SEG && S > 1) seg_free(c, sid);
}

using MsvKernel = void (*)(const int8_t*, const int64_t*, const int*,
                           const int*, int, int*, const long long*, int, int);

// The instance of a checked plan: by the launch's largest P and W, and
// whether a class reads its table from global memory (a table past
// shared memory takes 4 x 1056 lanes or more: P = 33), or is segmented
// (a group of 16 warps that reads its table from global memory, in
// blocks of 16 warps).
static MsvKernel msv_kernel(int pmax, int wmax, bool global, bool seg) {
  const int inst = msv_warps(pmax, wmax);
  if (seg) return msv_filter_kernel<33, 16, true, true>;
  if (inst == 8 && !global) return msv_filter_kernel<13, 8, false>;
  if (inst == 12 && !global) return msv_filter_kernel<33, 12, false>;
  if (inst == 12) return msv_filter_kernel<33, 12, true>;
  if (inst == 32 && global) return msv_filter_kernel<33, 32, true>;
  return nullptr;
}

// The blocks a single-model launch of <plan_host> (one class, no block
// rows, blocks of `warps` warps) keeps on the card at once, its blocks
// striding over the items: the SMs times the blocks an SM holds.  The
// host asks once a parameter set (loader.prepare_msv).  Returns 0 on a
// plan that does not check.
extern "C" int bt_msv_grid(const long long* plan_host, int warps) {
  int pmax, wmax;
  bool global, seg;
  size_t smem;
  if (msv_check(plan_host, 1, 0, warps, pmax, wmax, global, seg, smem))
    return 0;
  const MsvKernel kernel = msv_kernel(pmax, wmax, global, seg);
  if (!kernel) return 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  int dev = 0, sms = 1, per = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, 32 * warps,
                                                smem);
  return sms * (per > 0 ? per : 1);
}

// flat [N] int8 residues; offs [B] int64, lens and tjb [B] int32 per
// ORF; out [3, B] int32: xEu, xJm, movf, written at the plan's items.
// plan_host and plan: the plan's table (plan.cuh, the class row above)
// on the host and on the device, with ncls classes and nblk blocks of
// at most `warps` warps (the instance's, msv_warps, or fewer for a small
// batch spread over the SMs); nblk == 0 for one class whose `grid`
// blocks stride over all B items (a single-model call; bt_msv_grid).
// Returns the launch's cudaError_t.
extern "C" int bt_msv_filter(const void* flat, const void* offs,
                             const void* lens, const void* tjb, int B,
                             void* out, const long long* plan_host,
                             const void* plan, int ncls, int nblk, int warps,
                             int grid, void* stream) {
  if (B <= 0) return 0;
  int pmax, wmax;
  bool global, seg;
  size_t smem;
  const int err =
      msv_check(plan_host, ncls, nblk, warps, pmax, wmax, global, seg, smem);
  if (err) return err;
  const MsvKernel kernel = msv_kernel(pmax, wmax, global, seg);
  if (!kernel || grid < 1 || (nblk > 0 && grid != nblk))
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<grid, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,
      (const int*)tjb, B, (int*)out, (const long long*)plan, ncls, nblk);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_msv_filter_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(msv_seg_slot_bytes(Mp), n);
}
