// The SSV_BATH window capture: per ORF, the single-row SSV DP in MSV
// bytes with a constant xB; whenever a row's best cell reaches the
// ORF's threshold, the event (1-based row, first best model position in
// the SSE reference's striped order, score) goes to the next of 16
// slots and the whole row resets to 0.  The count runs past the slots;
// the host rescans such ORFs, as the reference's contract says.  The
// O(window) diagonal walks of each event stay on the host
// (ops/reference/filters.py ssv_windows_from_captures).
//
// Replaces the production jnp kernel bath_tpu/ops/jaxk/filters_mb.py
// _ssv_bath_mb_impl (ref: impl_sse/msvfilter.c :250).  Instead of its
// packed (score, order) argmax key over all lanes on every row, a row
// takes one vote of the group (does any thread's best cell reach the
// threshold?); only a row that crosses takes the maximum and a minimum
// of the striped order (stripes of 16, Q = max(2, ceil(M/16))) over the
// lanes holding it.
//
// What bounds it on the H100: the ORFs that pass the bias filter, a few
// thousand a flush, each a chain of dependent rows whose lane work is a
// few byte operations; a call takes about its longest ORF's chain, and
// that chain about the issue slots its warp gets on its scheduler.  The
// design:
// - MSV's class row (ops/multimodel.py ssv_plan, plan.cuh) and no block
//   rows: G groups of W warps a block, one ORF a group, the model's
//   int16 table (the MSV cost in bits 8-15, warp-transposed,
//   int_common.cuh lane_at) staged in shared memory where it fits; a
//   lane reads its cost as the word's high byte.
// - The ORFs longest first, sorted on the card (ssv_order), and dealt
//   round the blocks: block k's group g takes the ORF of rank
//   g * blocks + k, so block k starts with the k-th longest and the
//   blocks go heaviest first, and each of the longest ORFs runs on a
//   block, and so an SM, of its own, where the shorter ORFs beside it end
//   early and leave its warp the issue slots.
// - A row's serial path holds no memory load but its P cost bytes: the
//   ORF's residues are read ahead, 16 at a time as one aligned 16-byte
//   word the whole warp loads, the next word fetched while the rows of
//   the current one run (Residues).
// - The threshold test is a warp vote on each thread's own best (a
//   barrier reduction for W > 1 warps); the group's maximum and the
//   striped order are taken only on a row that crosses, which the
//   thresholds make rare.
// - The instances are MSV's (int_plan.cuh msv_warps), and a model past
//   a block's warps is segmented (int_common.cuh): its row's bytes wait
//   in the block's slot of the scratch between segments, a crossing row resets
//   lazily (the next row reads zeros) and its striped order is a second
//   walk over the stored row.

#include "int_common.cuh"
#include "int_plan.cuh"

constexpr int NCAP = 16;

namespace bi {

// The residues of one ORF, read ahead: every thread of the group holds
// the aligned 16-byte word of the current row's residue and the next
// word, fetched as soon as the current one is taken.  Only words that
// hold a residue of the ORF are read.
struct Residues {
  const int4* w;     // the aligned word holding residue 0
  int sh;            // residue 0's byte in it
  int last;          // the word of the last residue
  int at;            // the word in cur
  int4 cur, nxt;

  __device__ __forceinline__ void start(const int8_t* seq, int len) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(seq);
    w = reinterpret_cast<const int4*>(a & ~(uintptr_t)15);
    sh = (int)(a & 15);
    last = len > 0 ? (sh + len - 1) >> 4 : -1;
    at = 0;
    if (last >= 0) cur = w[0];
    if (last >= 1) nxt = w[1];
  }

  // residue i, for i = 0, 1, 2, ... in turn
  __device__ __forceinline__ int get(int i) {
    const int q = i + sh;
    if ((q >> 4) != at) {
      cur = nxt;
      ++at;
      if (at < last) nxt = w[at + 1];
    }
    const int c = q & 15;
    const unsigned v = c < 8 ? (c < 4 ? (unsigned)cur.x : (unsigned)cur.y)
                             : (c < 12 ? (unsigned)cur.z : (unsigned)cur.w);
    return (int)(int8_t)(v >> (8 * (c & 3)));
  }
};

// Records a crossing row's event (thread 0 of the group).
__device__ __forceinline__ void record(int* __restrict__ caps, int b, int B,
                                       int nwin, int row, int ord, int Q,
                                       int msc) {
  if (nwin < NCAP) {
    int* c = caps + (size_t)b * NCAP + nwin;
    c[0] = row;
    c[(size_t)B * NCAP] = (ord % 16) * Q + ord / 16 + 1;
    c[2 * (size_t)B * NCAP] = msc;
  }
}

// One ORF b on the group <g>.  <eb>: the table at this thread's lane 0,
// as bytes (lane j's cost at byte 64 j + 1 of row r at r * 2 Mp).
template <int P>
__device__ void ssv_item(const Group& g, const uint8_t* eb, int Mp, int M,
                         int base, int tbm, int bias, int b, int B,
                         const int8_t* __restrict__ flat,
                         const int64_t* __restrict__ offs,
                         const int* __restrict__ lens,
                         const int* __restrict__ tjb,
                         const int* __restrict__ thresh,
                         int* __restrict__ nwin_o, int* __restrict__ caps) {
  const int k0 = g.t * P;
  const int len = lens[b];
  const int xB = max(0, base - (tjb[b] + tbm));
  const int th = thresh[b];
  const int Q = max(2, (M + 15) / 16);
  Residues rs;
  rs.start(flat + offs[b], len);
  int dp[P];
#pragma unroll
  for (int j = 0; j < P; ++j) dp[j] = 0;
  int nwin = 0;
  for (int i = 0; i < len; ++i) {
    const uint8_t* e = eb + (size_t)rs.get(i) * 2 * Mp;
    const int mprev = lane_before(g, dp[P - 1], 0);
    int best = 0;
    // lanes past the model cost 255: their cells stay 0
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      int sv = max(j ? dp[j - 1] : mprev, xB);
      sv = max(min(sv + bias, 255) - (int)e[64 * j + 1], 0);
      dp[j] = sv;
      best = max(best, sv);
    }
    if (group_any(g, best >= th)) {  // the same on every thread
      const int msc = group_max(g, best);
      int ord = 16 * Q;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + j;
        if (k < M && dp[j] == msc) ord = min(ord, (k % Q) * 16 + k / Q);
        dp[j] = 0;
      }
      ord = group_min(g, ord);
      if (g.t == 0) record(caps, b, B, nwin, i + 1, ord, Q, msc);
      ++nwin;
    }
  }
  if (g.t == 0) nwin_o[b] = nwin;
}

// ssv_item for a segmented group: each row in S segments of 32 W P
// lanes, a lane's byte waiting in <slot> between them (segment s, lane
// j of thread t at (s P + j) 32 W + t).  A row that crosses is stored
// as it is and read as zeros by the next row; its striped order is a
// second walk over the stored row.  <tab>: the table bytes of lane 0.
template <int P>
__device__ void ssv_item_seg(const Group& g, const uint8_t* tab, int Mp,
                             int M, int S, int base, int tbm, int bias, int b,
                             int B, const int8_t* __restrict__ flat,
                             const int64_t* __restrict__ offs,
                             const int* __restrict__ lens,
                             const int* __restrict__ tjb,
                             const int* __restrict__ thresh,
                             int* __restrict__ nwin_o, int* __restrict__ caps,
                             uint8_t* slot, int* cx) {
  const int NT = 32 * g.W, SEG = NT * P;
  const int len = lens[b];
  const int xB = max(0, base - (tjb[b] + tbm));
  const int th = thresh[b];
  const int Q = max(2, (M + 15) / 16);
  Residues rs;
  rs.start(flat + offs[b], len);
  int nwin = 0;
  bool reset = true;  // the previous row crossed (or there is none)
  for (int i = 0; i < len; ++i) {
    const int res = rs.get(i);
    int best = 0;
    for (int s = 0; s < S; ++s) {
      const uint8_t* e = tab + (size_t)res * 2 * Mp +
                         2 * ((s * g.W + g.warp) * 32 * P + g.lane);
      uint8_t* st = slot + (size_t)s * SEG + g.t;
      int dp[P];
#pragma unroll
      for (int j = 0; j < P; ++j) dp[j] = reset ? 0 : (int)st[j * NT];
      const int mprev = lane_before_seg(g, dp[P - 1], 0, s, cx);
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        int sv = max(j ? dp[j - 1] : mprev, xB);
        sv = max(min(sv + bias, 255) - (int)e[64 * j + 1], 0);
        dp[j] = sv;
        best = max(best, sv);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) st[j * NT] = (uint8_t)dp[j];
    }
    reset = group_any(g, best >= th);
    if (reset) {
      const int msc = group_max(g, best);
      int ord = 16 * Q;
      for (int s = 0; s < S; ++s) {
        const uint8_t* st = slot + (size_t)s * SEG + g.t;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int k = s * SEG + g.t * P + j;
          if (k < M && (int)st[j * NT] == msc)
            ord = min(ord, (k % Q) * 16 + k / Q);
        }
      }
      ord = group_min(g, ord);
      if (g.t == 0) record(caps, b, B, nwin, i + 1, ord, Q, msc);
      ++nwin;
    }
  }
  if (g.t == 0) nwin_o[b] = nwin;
}

}  // namespace bi

// The class row is MSV's (msv_filter.cu): the address of the stacked
// tables [g][Kp][Mp] int16 (warp-transposed), of the scalars [g][5] int
// (M, base, tec, tbm, bias), P, W, Mp, G, Kp, whether a block stages the
// table in shared memory (GLOBAL: it may not), the segments S and a
// segmented class's scratch (SEG), model 0.  <order>: the ORFs longest
// first; block k's group g (of <groups> a block) takes rank
// g * gridDim.x + k.
template <int PMAX, int WARPS, bool GLOBAL, bool SEG = false>
__global__ void __launch_bounds__(32 * WARPS)
    ssv_capture_kernel(const int8_t* __restrict__ flat,
                       const int64_t* __restrict__ offs,
                       const int* __restrict__ lens,
                       const int* __restrict__ tjb,
                       const int* __restrict__ thresh, int B,
                       int* __restrict__ nwin, int* __restrict__ caps,
                       const int64_t* __restrict__ order, int groups,
                       const long long* __restrict__ c) {
  extern __shared__ int4 smem4[];
  const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], Kp = (int)c[6];
  const bool staged = !GLOBAL || c[7] != 0;
  const uint16_t* tg = reinterpret_cast<const uint16_t*>(c[0]);
  const int* s = reinterpret_cast<const int*>(c[1]);
  const size_t tab_bytes = (size_t)Kp * Mp * sizeof(uint16_t);
  const uint16_t* tab = reinterpret_cast<const uint16_t*>(smem4);
  if (staged)
    bi::stage_words(tg, tab_bytes, smem4);
  else
    tab = tg;
  const int gi = (threadIdx.x >> 5) / W;
  const int rank = gi * gridDim.x + blockIdx.x;
  if (gi >= groups || rank >= B) return;
  const int b = (int)order[rank];
  bi::Group g = bi::make_group(
      W, reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                (staged ? tab_bytes : 0)) +
             4 * W * gi);
  g.bar = 1 + gi;
  const uint8_t* tb = reinterpret_cast<const uint8_t*>(tab);
  const int M = s[0], base = s[1], tbm = s[3], bias = s[4];
  const int S = SEG ? (int)c[8] : 1;
  // a segmented class: one group a block, which takes a slot of the
  // class's scratch, its carry past the group's scratch
  int* cx = g.x + 4 * W;
  uint8_t* slot = nullptr;
  int sid = 0;
  if (SEG && S > 1)
    slot = reinterpret_cast<uint8_t*>(
        seg_take(c, ssv_seg_slot_bytes(Mp), cx, sid));
#define BI_SSV_ITEM(PP)                                                      \
  if constexpr (PP <= PMAX) {                                                \
    if (SEG && S > 1)                                                        \
      bi::ssv_item_seg<PP>(g, tb, Mp, M, S, base, tbm, bias, b, B, flat,     \
                           offs, lens, tjb, thresh, nwin, caps, slot, cx);   \
    else                                                                     \
      bi::ssv_item<PP>(g, tb + 2 * (g.warp * 32 * PP + g.lane), Mp, M, base, \
                       tbm, bias, b, B, flat, offs, lens, tjb, thresh, nwin, \
                       caps);                                                \
  }                                                                          \
  break;
  switch (P) {  // the plan's classes are checked on the host (msv_check)
    case 3: BI_SSV_ITEM(3)
    case 5: BI_SSV_ITEM(5)
    case 9: BI_SSV_ITEM(9)
    case 13: BI_SSV_ITEM(13)
    case 17: BI_SSV_ITEM(17)
    case 25: BI_SSV_ITEM(25)
    case 33: BI_SSV_ITEM(33)
  }
#undef BI_SSV_ITEM
  if (SEG && S > 1) seg_free(c, sid);
}

using SsvKernel = void (*)(const int8_t*, const int64_t*, const int*,
                           const int*, const int*, int, int*, int*,
                           const int64_t*, int, const long long*);

// The instance of a checked plan, as msv_filter.cu picks MSV's (a
// segmented model's blocks are its group's 16 warps).
static SsvKernel ssv_kernel(int pmax, int wmax, bool global, bool seg) {
  const int inst = msv_warps(pmax, wmax);
  if (seg) return ssv_capture_kernel<33, 16, true, true>;
  if (inst == 8 && !global) return ssv_capture_kernel<13, 8, false>;
  if (inst == 12 && !global) return ssv_capture_kernel<33, 12, false>;
  if (inst == 12) return ssv_capture_kernel<33, 12, true>;
  if (inst == 32 && global) return ssv_capture_kernel<33, 32, true>;
  return nullptr;
}

// flat [N] int8 residues; offs [B] int64, lens, tjb and thresh [B] int32
// per ORF; nwin [B] int32; caps [3, B, 16] int32 (row, k, score), zeroed
// by the caller; order [B] int64: the ORFs longest first; `groups` ORFs
// a block, `blocks` blocks (ops/multimodel.py ssv_blocks).  plan_host and
// plan: MSV's class row of the model (ops/multimodel.py ssv_plan) on the
// host and on the device, for blocks of `warps` warps.  Returns the
// launch's cudaError_t.
extern "C" int bt_ssv_capture(const void* flat, const void* offs,
                              const void* lens, const void* tjb,
                              const void* thresh, int B, void* nwin,
                              void* caps, const void* order, int groups,
                              int blocks, const long long* plan_host,
                              const void* plan, int warps, void* stream) {
  if (B <= 0) return 0;
  int pmax, wmax;
  bool global, seg;
  size_t smem;
  const int err =
      msv_check(plan_host, 1, -1, warps, pmax, wmax, global, seg, smem);
  if (err) return err;
  const SsvKernel kernel = ssv_kernel(pmax, wmax, global, seg);
  const int W = (int)plan_host[3];
  if (!kernel || groups < 1 || groups > (int)plan_host[5] || blocks < 1 ||
      (long long)groups * blocks < B)
    return cudaErrorInvalidValue;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  kernel<<<blocks, 32 * W * groups, smem,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,
      (const int*)tjb, (const int*)thresh, B, (int*)nwin, (int*)caps,
      (const int64_t*)order, groups, (const long long*)plan);
  return (int)cudaGetLastError();
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes; -1 for n < 1.
extern "C" long long bt_ssv_capture_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(ssv_seg_slot_bytes(Mp), n);
}
