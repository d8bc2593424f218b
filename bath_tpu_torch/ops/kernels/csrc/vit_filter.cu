// The ViterbiFilter (F2) and its ViterbiFilter_BATH window capture: per
// ORF, the int16-saturated max-plus Viterbi with the N/J/C/B specials
// under the ORF's own length model (the move word), every add saturated
// in the reference's order.  The score entry returns the final C term,
// whether C was reached and whether any row saturated; the capture
// entry (CAPTURE) returns, per row whose xE reaches the ORF's threshold
// and does not saturate, the first model position in the SSE
// reference's striped order (stripes of 8, Q = max(2, ceil(M/8))) whose
// M cell equals xE, and the first saturated row.  The host replays the
// events (skip_until and the O(window) extensions).
//
// Replaces the TPU kernel bath_tpu/ops/pallas/vit.py _vit_kernel
// (vit_ints_pallas, Pallas #3), the production jnp kernels
// bath_tpu/ops/jaxk/filters_mb.py _vit_mb_impl and _vit_bath_mb_impl
// (ref: impl_sse/vitfilter.c :39, :286), and the Viterbi half of
// bath_tpu/evalues_device.py _dyn_kernels (the vmap of _vit_mb_impl over
// models with base_w and the xE move/loop words as traced values).  The
// D->D chain D[k] = max(part[k], sat(D[k-1] + tDD[k])), which the TPU
// closes with a log-depth lane scan, is here a sequential run per thread
// reduced to one (max, +) map, a warp-shuffle scan of the maps, and a
// replay of the run from its carry (int_common.cuh: exact because every
// tDD <= 0).
//
// What bounds it on the H100: a chain of dependent rows per ORF, each
// with ~25 integer operations and nine table words per model lane, one
// group max, the map scan (5 shuffle steps) and two lane exchanges.
// The design:
// - One launch for every padded width of a call (plan.cuh; ops/
//   multimodel.py vit_plan), blocks heaviest first (Mp x longest ORF),
//   so a call takes about its heaviest chain and not the sum over its
//   widths.  A single-model call is a plan of one class.
// - Each block holds G groups of W warps, one ORF a group, all of one
//   model, whose table it stages in shared memory once, as int16 words:
//   37 x Mp x 2 bytes, 201 KB at Mp = 2720 (five warps of 17 lanes,
//   loader.vit_layout).  The match words are stored warp-transposed (a
//   warp's 32P lanes as P rows of 32), so lane j of the 32 threads is 32
//   neighbouring halfwords: no bank conflict, where int16 words at an
//   odd stride P would meet two to a bank; the eight transition rows are
//   stored as four rows of int16 pairs in one int: five reads a lane and
//   row where there were nine.  A model past M = 2720, whose table does
//   not fit the 227 KB a block may take, reads the same layout from a
//   copy in global memory that its pack holds (ops/multimodel.py
//   vit_global_tables; the class row's word 7), through L2, in a kernel
//   instance of its own, so that every other launch reads its tables as
//   shared memory (32-bit addresses, fewer registers).
// - Groups of W > 1 warps sync on a named barrier of their own, so G
//   such groups share a block and its copy of the table.
// - The kernel is instantiated for the largest P of the launch (13, 17
//   or 33), so a call of narrow models pays no wide model's registers;
//   its block size is fixed per instance (vit_warps) and bounds the
//   registers a thread may take.  One warp takes up to 33 lanes a
//   thread (fewest instructions an item: the calibration's many equal
//   items are throughput-bound), a longer model W warps of 17.
// - A model past 16 warps of 17 lanes (M = 8704) takes a group of 16
//   warps, which walks each row in S segments (int_common.cuh): a lane's
//   M, I and D words wait in the block's slot of the class's scratch
//   (plan.cuh seg_take) between segments, the
//   row's maximum and a capture's striped order are taken after the last
//   one.  It runs an instance of its own, blocks of 16 warps, which also
//   takes the launch's other classes (and a launch of 13-16 warps of 17
//   lanes beside a warp of 33, which no other instance holds).

#include "int_common.cuh"
#include "plan.cuh"

// transition rows of the table (ops/vit.py R_*), stored in shared memory
// as the pairs (BM, MM), (IM, DM), (MDS, DDS), (MI, II)
enum { R_BM = 0, R_MM, R_IM, R_DM, R_MDS, R_DDS, R_MI, R_II, NTR };
constexpr int VIT_PAIRS = NTR / 2;

// Bytes of a segmented group's slot (plan.cuh) of a class of Mp padded
// lanes: the int16 M, I and D rows (vit_item_seg).
__host__ __device__ constexpr size_t vit_seg_slot_bytes(int Mp) {
  return (size_t)3 * Mp * sizeof(int16_t);
}

// Warps of a block of the instance for lanes up to <pmax>
// (ops/multimodel.py vit_block_warps), or 16 for the segmented one.
__host__ __device__ constexpr int vit_warps(int pmax, bool seg = false) {
  return seg ? 16 : pmax <= 13 ? 8 : pmax <= 17 ? 16 : 12;
}

__host__ __device__ constexpr int vit_instance(int pmax) {
  return pmax <= 13 ? 13 : pmax <= 17 ? 17 : 33;
}

// Shared bytes of a block: the transition pairs [4][Mp] int, the match
// words [Kp][Mp] int16 (16-byte aligned) and each group's scratch of 4W
// ints (ops/multimodel.py vit_smem_bytes).
__host__ __device__ constexpr size_t vit_table_bytes(int Kp, int Mp) {
  return ((size_t)VIT_PAIRS * Mp * 4 + (size_t)Kp * Mp * 2 + 15) / 16 * 16;
}

__host__ __device__ constexpr size_t vit_smem_bytes(int Kp, int Mp, int G,
                                                    int W) {
  return vit_table_bytes(Kp, Mp) + (size_t)G * 16 * W;
}

namespace bi {

__device__ __forceinline__ int lo16(int w) {
  return (int)(int16_t)(uint16_t)(w & 0xffff);
}

__device__ __forceinline__ int hi16(int w) { return w >> 16; }

// One ORF b under one model, on the group <g>.  <ew>, <tw>: the match
// words and transition pairs at this thread's lane 0 (lane j at +32j).
template <int P, bool CAPTURE>
__device__ void vit_item(const Group& g, const int16_t* ew, const int* tw,
                         int Mp, int M, int base, int emove, int eloop, int b,
                         int B, const int8_t* __restrict__ flat,
                         const int64_t* __restrict__ offs,
                         const int* __restrict__ lens,
                         const int* __restrict__ move,
                         const int* __restrict__ thresh,
                         int* __restrict__ out, int16_t* __restrict__ karr) {
  const int k0 = g.t * P;
  const int Q = max(2, (M + 7) / 8);
  const int len = lens[b];
  const int mv = move[b];
  const int th = CAPTURE ? thresh[b] : 0;
  const int8_t* seq = flat + offs[b];
  int16_t* krow = CAPTURE ? karr + offs[b] : nullptr;
  int dm[P], di[P], dd[P];
#pragma unroll
  for (int j = 0; j < P; ++j) dm[j] = di[j] = dd[j] = NEG;
  int xJ = NEG, xC = NEG, xB = base + mv;
  int ovf = 0, score = 0, has = 0, ovfrow = 0;
  for (int i = 0; i < len; ++i) {
    const int16_t* e = ew + (int)seq[i] * Mp;
    int mp, ip, dpv;
    lane_before(g, dm[P - 1], di[P - 1], dd[P - 1], NEG, mp, ip, dpv);
    // M and I rows in place, high lane first (lane j reads j-1's old row)
    int xE = NEG;
#pragma unroll
    for (int j = P - 1; j >= 0; --j) {
      const int k = k0 + j;
      const int bm_mm = tw[32 * j];
      const int im_dm = tw[Mp + 32 * j];
      const int mi_ii = tw[3 * Mp + 32 * j];
      int sv = sat16(xB + lo16(bm_mm));
      sv = max(sv, sat16((j ? dm[j - 1] : mp) + hi16(bm_mm)));
      sv = max(sv, sat16((j ? di[j - 1] : ip) + lo16(im_dm)));
      sv = max(sv, sat16((j ? dd[j - 1] : dpv) + hi16(im_dm)));
      sv = sat16(sv + (int)e[32 * j]);
      di[j] = max(sat16(dm[j] + lo16(mi_ii)), sat16(di[j] + hi16(mi_ii)));
      dm[j] = sv;
      if (k < M) xE = max(xE, sv);
    }
    xE = group_max(g, xE);
    const bool ovf2 = xE >= 32767;
    if (CAPTURE) {
      if (xE >= th && !ovf2) {  // the same on every thread of the group
        int ord = 8 * Q;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int k = k0 + j;
          if (k < M && dm[j] == xE) ord = min(ord, (k % Q) * 8 + k / Q);
        }
        ord = group_min(g, ord);
        if (g.t == 0) krow[i] = (int16_t)((ord % 8) * Q + ord / 8 + 1);
      }
      if (ovf2 && ovfrow == 0) ovfrow = i + 1;
    }
    // D row: part[k] = sat(M[k-1] + tMD[k]), closed along k by the map
    // scan; the parts wait in dd
    const int svprev = lane_before(g, dm[P - 1], NEG);
    MaxPlus run{0, NEG};
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int md_dd = tw[2 * Mp + 32 * j];
      dd[j] = sat16((j ? dm[j - 1] : svprev) + lo16(md_dd));
      run = mp_then(run, MaxPlus{hi16(md_dd), dd[j]});
    }
    int y = group_scan_excl(g, run).b;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      y = max(dd[j], sat16(y + hi16(tw[2 * Mp + 32 * j])));
      dd[j] = y;
    }
    xC = max(xC, xE + emove);
    xJ = max(xJ, xE + eloop);
    xB = sat16(max(xJ, base) + mv);
    ovf |= ovf2;
    if (i == len - 1) {
      score = xC + mv;
      has = xC > NEG;
    }
  }
  if (g.t == 0) {
    if (CAPTURE) {
      out[b] = ovfrow;
    } else {
      out[b] = score;
      out[B + b] = has;
      out[2 * B + b] = ovf;
    }
  }
}

// vit_item for a segmented group: each row in S segments of 32 W P
// lanes; between them a lane's M, I and D words wait in <slot> (rows v
// = 0, 1, 2 of segment s, lane j of thread t at ((3 s + v) P + j) 32 W
// + t).  A segment takes the previous segment's last lane of the
// previous row (cx[0..2]) and of this row's M (cx[3]), and the D chain's
// carry; xE and a capture's striped order come after the last segment.
// <rwv>, <trp>: the match words and transition pairs of lane 0.
template <int P, bool CAPTURE>
__device__ void vit_item_seg(const Group& g, const int16_t* rwv,
                             const int* trp, int Mp, int M, int S, int base,
                             int emove, int eloop, int b, int B,
                             const int8_t* __restrict__ flat,
                             const int64_t* __restrict__ offs,
                             const int* __restrict__ lens,
                             const int* __restrict__ move,
                             const int* __restrict__ thresh,
                             int* __restrict__ out,
                             int16_t* __restrict__ karr, int16_t* slot,
                             int* cx) {
  const int NT = 32 * g.W, SEG = NT * P;
  const int Q = max(2, (M + 7) / 8);
  const int len = lens[b];
  const int mv = move[b];
  const int th = CAPTURE ? thresh[b] : 0;
  const int8_t* seq = flat + offs[b];
  int16_t* krow = CAPTURE ? karr + offs[b] : nullptr;
  int xJ = NEG, xC = NEG, xB = base + mv;
  int ovf = 0, score = 0, has = 0, ovfrow = 0;
  for (int i = 0; i < len; ++i) {
    const int res = (int)seq[i];
    int xE = NEG, dcarry = NEG;
    for (int s = 0; s < S; ++s) {
      const int k0 = s * SEG + g.t * P;
      const int at = (s * g.W + g.warp) * 32 * P + g.lane;
      const int16_t* e = rwv + at + (size_t)res * Mp;
      const int* tw = trp + at;
      int16_t* st = slot + (size_t)s * 3 * SEG + g.t;
      int dm[P], di[P], dd[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        dm[j] = i ? (int)st[j * NT] : NEG;
        di[j] = i ? (int)st[SEG + j * NT] : NEG;
        dd[j] = i ? (int)st[2 * SEG + j * NT] : NEG;
      }
      int mp, ip, dpv;
      lane_before_seg(g, dm[P - 1], di[P - 1], dd[P - 1], NEG, s, cx, mp, ip,
                      dpv);
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int k = k0 + j;
        const int bm_mm = tw[32 * j];
        const int im_dm = tw[Mp + 32 * j];
        const int mi_ii = tw[3 * Mp + 32 * j];
        int sv = sat16(xB + lo16(bm_mm));
        sv = max(sv, sat16((j ? dm[j - 1] : mp) + hi16(bm_mm)));
        sv = max(sv, sat16((j ? di[j - 1] : ip) + lo16(im_dm)));
        sv = max(sv, sat16((j ? dd[j - 1] : dpv) + hi16(im_dm)));
        sv = sat16(sv + (int)e[32 * j]);
        di[j] = max(sat16(dm[j] + lo16(mi_ii)), sat16(di[j] + hi16(mi_ii)));
        dm[j] = sv;
        if (k < M) xE = max(xE, sv);
      }
      const int svprev = lane_before_seg(g, dm[P - 1], NEG, s, cx + 3);
      MaxPlus run{0, NEG};
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int md_dd = tw[2 * Mp + 32 * j];
        dd[j] = sat16((j ? dm[j - 1] : svprev) + lo16(md_dd));
        run = mp_then(run, MaxPlus{hi16(md_dd), dd[j]});
      }
      MaxPlus tot;
      int y = mp_apply(group_scan_seg(g, run, tot), dcarry);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        y = max(dd[j], sat16(y + hi16(tw[2 * Mp + 32 * j])));
        dd[j] = y;
      }
      dcarry = mp_apply(tot, dcarry);
#pragma unroll
      for (int j = 0; j < P; ++j) {
        st[j * NT] = (int16_t)dm[j];
        st[SEG + j * NT] = (int16_t)di[j];
        st[2 * SEG + j * NT] = (int16_t)dd[j];
      }
    }
    xE = group_max(g, xE);
    const bool ovf2 = xE >= 32767;
    if (CAPTURE) {
      if (xE >= th && !ovf2) {  // the same on every thread of the group
        int ord = 8 * Q;
        for (int s = 0; s < S; ++s) {
          const int16_t* st = slot + (size_t)s * 3 * SEG + g.t;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int k = s * SEG + g.t * P + j;
            if (k < M && (int)st[j * NT] == xE)
              ord = min(ord, (k % Q) * 8 + k / Q);
          }
        }
        ord = group_min(g, ord);
        if (g.t == 0) krow[i] = (int16_t)((ord % 8) * Q + ord / 8 + 1);
      }
      if (ovf2 && ovfrow == 0) ovfrow = i + 1;
    }
    xC = max(xC, xE + emove);
    xJ = max(xJ, xE + eloop);
    xB = sat16(max(xJ, base) + mv);
    ovf |= ovf2;
    if (i == len - 1) {
      score = xC + mv;
      has = xC > NEG;
    }
  }
  if (g.t == 0) {
    if (CAPTURE) {
      out[b] = ovfrow;
    } else {
      out[b] = score;
      out[B + b] = has;
      out[2 * B + b] = ovf;
    }
  }
}

}  // namespace bi

// The class row of the plan (plan.cuh): the address of the class's
// stacked tables [g][Kp + 8][Mp] int16 (ops/vit.py VitParams.table), the
// address of its scalars [g][4] int (M, base, emove, eloop), P, W, Mp,
// G, Kp, and 0, or the address of the tables in the kernel's layout
// ([g] blocks of vit_table_bytes: the transition pairs, then the match
// words) for a class whose blocks read them from global memory, the
// segments S and the address of a segmented class's scratch (SEG).
template <int PMAX, bool CAPTURE, bool GLOBAL, bool SEG = false>
__global__ void __launch_bounds__(32 * vit_warps(PMAX, SEG))
    vit_filter_kernel(const int8_t* __restrict__ flat,
                      const int64_t* __restrict__ offs,
                      const int* __restrict__ lens,
                      const int* __restrict__ move,
                      const int* __restrict__ thresh, int B,
                      int* __restrict__ out, int16_t* __restrict__ karr,
                      const long long* __restrict__ plan, int ncls,
                      int nblk) {
  extern __shared__ int4 smem4[];
  const PlanBlock pb = plan_block(plan, ncls, nblk);
  const long long* c = pb.cls;
  const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], Kp = (int)c[6];
  const int16_t* tg = reinterpret_cast<const int16_t*>(c[0]) +
                      (size_t)pb.model * (Kp + NTR) * Mp;
  const int* s = reinterpret_cast<const int*>(c[1]) + 4 * pb.model;
  const bool from_global = GLOBAL && c[7] != 0;
  const int* trp;
  const int16_t* rwv;
  if (from_global) {
    trp = reinterpret_cast<const int*>(
        reinterpret_cast<const char*>(c[7]) +
        (size_t)pb.model * vit_table_bytes(Kp, Mp));
  } else {
    int* st = reinterpret_cast<int*>(smem4);
    int16_t* sw = reinterpret_cast<int16_t*>(st + VIT_PAIRS * Mp);
    for (int x = threadIdx.x; x < Mp; x += blockDim.x) {
      const int k = bi::lane_at(x, P);
#pragma unroll
      for (int q = 0; q < VIT_PAIRS; ++q)
        st[q * Mp + x] =
            (int)((unsigned)(uint16_t)tg[(Kp + 2 * q) * Mp + k] |
                  ((unsigned)(uint16_t)tg[(Kp + 2 * q + 1) * Mp + k] << 16));
      for (int r = 0; r < Kp; ++r) sw[r * Mp + x] = tg[r * Mp + k];
    }
    __syncthreads();
    trp = st;
  }
  rwv = reinterpret_cast<const int16_t*>(trp + VIT_PAIRS * Mp);
  if (pb.item < 0) return;
  bi::Group g = bi::make_group(
      W, reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                (from_global ? 0 : vit_table_bytes(Kp, Mp))) +
             4 * W * pb.gi);
  g.bar = 1 + pb.gi;
  const int at = g.warp * 32 * P + g.lane;
  const int M = pb.M, base = s[1], emove = s[2], eloop = s[3];
  const int S = SEG ? (int)c[8] : 1;
  // a segmented class: one group a block, which takes a slot of the
  // class's scratch, its carries past the group's scratch
  int* cx = g.x + 4 * W;
  int16_t* slot = nullptr;
  int sid = 0;
  if (SEG && S > 1)
    slot = reinterpret_cast<int16_t*>(
        seg_take(c, vit_seg_slot_bytes(Mp), cx, sid));
#define BI_VIT_ITEM(PP)                                                   \
  if constexpr (PP <= PMAX) {                                             \
    if (SEG && S > 1)                                                     \
      bi::vit_item_seg<PP, CAPTURE>(g, rwv, trp, Mp, M, S, base, emove,   \
                                    eloop, pb.item, B, flat, offs, lens,  \
                                    move, thresh, out, karr, slot, cx);   \
    else                                                                  \
      bi::vit_item<PP, CAPTURE>(g, rwv + at, trp + at, Mp, M, base,       \
                                emove, eloop, pb.item, B, flat, offs,     \
                                lens, move, thresh, out, karr);           \
  }                                                                       \
  break;
  switch (P) {
    case 3: BI_VIT_ITEM(3)
    case 5: BI_VIT_ITEM(5)
    case 9: BI_VIT_ITEM(9)
    case 13: BI_VIT_ITEM(13)
    case 17: BI_VIT_ITEM(17)
    case 25: BI_VIT_ITEM(25)
    case 33: BI_VIT_ITEM(33)
  }
#undef BI_VIT_ITEM
  if (SEG && S > 1) seg_free(c, sid);
}

// Checks a plan's classes (the host copy of the table) and gives the
// instance (vit_instance of the largest P), whether the launch takes
// the segmented one (a segmented class, or blocks of more warps than
// that instance's), and the launch's dynamic shared memory.  Returns 0,
// or a cudaError_t.
static int vit_check(const long long* plan, int ncls, int warps, int& inst,
                     bool& global, bool& seg, size_t& smem) {
  const int cap = plan_smem_optin();
  if (ncls <= 0 || warps <= 0) return cudaErrorInvalidValue;
  int pmax = 0;
  global = seg = false;
  smem = 0;
  for (int i = 0; i < ncls; ++i) {
    const long long* c = plan + PLAN_CLS * i;
    const int P = (int)c[2], W = (int)c[3], Mp = (int)c[4], G = (int)c[5];
    const int Kp = (int)c[6], S = (int)c[8];
    if (!(P == 3 || P == 5 || P == 9 || P == 13 || P == 17 || P == 25 ||
          P == 33) ||
        W < 1 || S < 1 || Mp != 32 * P * W * S || G < 1 || G * W > warps ||
        (W > 1 && G > 15) || Kp < 1 ||
        (S > 1 && (W < 2 || G != 1 || c[9] == 0 || c[7] == 0)))
      return cudaErrorInvalidValue;
    const size_t need = (c[7] ? (size_t)G * 16 * W
                              : vit_smem_bytes(Kp, Mp, G, W)) +
                        (S > 1 ? 32 : 0);
    smem = need > smem ? need : smem;
    pmax = P > pmax ? P : pmax;
    global = global || c[7] != 0;
    seg = seg || S > 1;
  }
  inst = vit_instance(pmax);
  seg = seg || warps > vit_warps(inst);
  if (warps > vit_warps(inst, seg)) return cudaErrorInvalidValue;
  return smem <= (size_t)cap ? 0 : cudaErrorInvalidValue;
}

template <int PMAX, bool CAPTURE, bool GLOBAL, bool SEG = false>
static void vit_launch_instance(const void* flat, const void* offs,
                                const void* lens, const void* move,
                                const void* thresh, int B, void* out,
                                void* karr, const void* plan, int ncls,
                                int nblk, int warps, size_t smem,
                                cudaStream_t st) {
  cudaFuncSetAttribute(vit_filter_kernel<PMAX, CAPTURE, GLOBAL, SEG>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  vit_filter_kernel<PMAX, CAPTURE, GLOBAL, SEG>
      <<<nblk, 32 * warps, smem, st>>>(
      (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,
      (const int*)move, (const int*)thresh, B, (int*)out, (int16_t*)karr,
      (const long long*)plan, ncls, nblk);
}

template <bool CAPTURE>
static int vit_launch(const void* flat, const void* offs, const void* lens,
                      const void* move, const void* thresh, int B, void* out,
                      void* karr, const long long* plan_host, const void* plan,
                      int ncls, int nblk, int warps, void* stream) {
  if (nblk <= 0) return 0;
  int inst;
  bool global, seg;
  size_t smem;
  const int err = vit_check(plan_host, ncls, warps, inst, global, seg, smem);
  if (err) return err;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  // a segmented group reads its tables from global memory; the instance
  // takes every P of the launch
  if (seg)
    vit_launch_instance<33, CAPTURE, true, true>(flat, offs, lens, move,
                                                 thresh, B, out, karr, plan,
                                                 ncls, nblk, warps, smem, st);
  // a table past shared memory takes six warps of 17 lanes or more
  else if (global && inst == 13) return cudaErrorInvalidValue;
  else if (inst == 13)
    vit_launch_instance<13, CAPTURE, false>(flat, offs, lens, move, thresh,
                                            B, out, karr, plan, ncls, nblk,
                                            warps, smem, st);
  else if (inst == 17 && !global)
    vit_launch_instance<17, CAPTURE, false>(flat, offs, lens, move, thresh,
                                            B, out, karr, plan, ncls, nblk,
                                            warps, smem, st);
  else if (inst == 17)
    vit_launch_instance<17, CAPTURE, true>(flat, offs, lens, move, thresh,
                                           B, out, karr, plan, ncls, nblk,
                                           warps, smem, st);
  else if (!global)
    vit_launch_instance<33, CAPTURE, false>(flat, offs, lens, move, thresh,
                                            B, out, karr, plan, ncls, nblk,
                                            warps, smem, st);
  else
    vit_launch_instance<33, CAPTURE, true>(flat, offs, lens, move, thresh,
                                           B, out, karr, plan, ncls, nblk,
                                           warps, smem, st);
  return (int)cudaGetLastError();
}

// flat [N] int8 residues; offs [B] int64, lens and move [B] int32 per
// ORF; out [3, B] int32: score_int, has, ovf, written at the plan's
// items.  plan_host and plan: the plan's table (plan.cuh, the class row
// above) on the host and on the device, with ncls classes and nblk
// blocks of `warps` warps.  One entry serves the single-model calls
// (#3) and the multi-model ones (the device calibration): a single
// model is a plan of one class.  Returns the launch's cudaError_t.
extern "C" int bt_vit_filter(const void* flat, const void* offs,
                             const void* lens, const void* move, int B,
                             void* out, const long long* plan_host,
                             const void* plan, int ncls, int nblk, int warps,
                             void* stream) {
  return vit_launch<false>(flat, offs, lens, move, nullptr, B, out, nullptr,
                           plan_host, plan, ncls, nblk, warps, stream);
}

// As bt_vit_filter, with thresh [B] int32 per ORF; out [B] int32: the
// first saturated row (1-based, 0 if none); karr [N] int16 in the layout
// of flat, zeroed by the caller: the striped-order k_start at each
// crossing row.  Returns the launch's cudaError_t.
extern "C" int bt_vit_capture(const void* flat, const void* offs,
                              const void* lens, const void* move,
                              const void* thresh, int B, void* out,
                              void* karr, const long long* plan_host,
                              const void* plan, int ncls, int nblk, int warps,
                              void* stream) {
  return vit_launch<true>(flat, offs, lens, move, thresh, B, out, karr,
                          plan_host, plan, ncls, nblk, warps, stream);
}

// Bytes of a segmented class's scratch of n slots (plan.cuh), for a
// class of Mp padded lanes (the filter's and the capture's); -1 for
// n < 1.
extern "C" long long bt_vit_filter_seg_bytes(int Mp, int n) {
  return seg_scratch_bytes(vit_seg_slot_bytes(Mp), n);
}
