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
// (vit_ints_pallas, Pallas #3) and the production jnp kernels
// bath_tpu/ops/jaxk/filters_mb.py _vit_mb_impl and _vit_bath_mb_impl
// (ref: impl_sse/vitfilter.c :39, :286).  The D->D chain
// D[k] = max(part[k], sat(D[k-1] + tDD[k])), which the TPU closes with a
// log-depth lane scan, is here a sequential run per thread reduced to
// one (max, +) map, a warp-shuffle scan of the maps, and a replay of
// the run from its carry (int_common.cuh: exact because every tDD <= 0).
//
// What bounds it on the H100: a chain of dependent rows per ORF, each
// with ~25 integer operations per model lane, one warp max, the map
// scan (5 shuffle steps) and two lane exchanges.  Latency of that chain
// bounds one ORF; the F2 stage sees only the bias survivors of a flush
// (thousands), so the design keeps one warp per ORF, eight to a block,
// the word tables in shared memory when they fit.
//
// The multi-model entry bt_vit_filter_multi replaces the Viterbi half of
// bath_tpu/evalues_device.py _dyn_kernels (the vmap of _vit_mb_impl over
// models with base_w and the xE move/loop words as traced values): item
// b is filtered under model slot[b].  It is this same kernel (the score
// entry), so the same arithmetic item for item; the models' tables of
// one padded width Mp are stacked [G, Kp + 8, Mp], a block finds its
// model and its items in a per-block table (bi::block_items) and reads
// that model's M, base, emove and eloop from one row of scal [G, 4]; one
// launch per Mp.  The same bound holds: the row chain of each item.

#include "int_common.cuh"

// transition rows of the table (ops/vit.py R_*)
enum { R_BM = 0, R_MM, R_IM, R_DM, R_MDS, R_DDS, R_MI, R_II, NTR };

template <int P, bool CAPTURE>
__global__ void vit_filter_kernel(const int8_t* __restrict__ flat,
                                  const int64_t* __restrict__ offs,
                                  const int* __restrict__ lens,
                                  const int* __restrict__ move,
                                  const int* __restrict__ thresh, int B,
                                  const int* __restrict__ tab_g, int Kp, int M,
                                  int Mp, int W, bool in_smem, int base,
                                  int emove, int eloop, int* __restrict__ out,
                                  int16_t* __restrict__ karr,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ order,
                                  const int* __restrict__ scal) {
  extern __shared__ int smem[];
  const bi::Items it = bi::block_items(blk, B, W);
  if (blk != nullptr) {  // this block's model: its scalars and its table
    const int* s = scal + 4 * it.model;
    M = s[0];
    base = s[1];
    emove = s[2];
    eloop = s[3];
  }
  const int n_tab = (Kp + NTR) * Mp;
  const int* rwv = bi::load_table(tab_g + (size_t)it.model * n_tab, n_tab, smem,
                                  in_smem);
  const int* tr = rwv + Kp * Mp;
  const bi::Group g = bi::make_group(W, smem + (in_smem ? n_tab : 0));
  const int k0 = g.t * P;
  const int Q = max(2, (M + 7) / 8);
  for (int q = it.first; q < it.end; q += it.step) {
    const int b = blk != nullptr ? order[q] : q;
    const int len = lens[b];
    const int mv = move[b];
    const int th = CAPTURE ? thresh[b] : 0;
    const int8_t* seq = flat + offs[b];
    int16_t* krow = CAPTURE ? karr + offs[b] : nullptr;
    int dm[P], di[P], dd[P];
#pragma unroll
    for (int j = 0; j < P; ++j) dm[j] = di[j] = dd[j] = bi::NEG;
    int xJ = bi::NEG, xC = bi::NEG, xB = base + mv;
    int ovf = 0, score = 0, has = 0, ovfrow = 0;
    for (int i = 0; i < len; ++i) {
      const int* e = rwv + (int)seq[i] * Mp + k0;
      int mp, ip, dpv;
      bi::lane_before(g, dm[P - 1], di[P - 1], dd[P - 1], bi::NEG, mp, ip, dpv);
      // M and I rows in place, high lane first (lane j reads j-1's old row)
      int xE = bi::NEG;
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int k = k0 + j;
        int sv = bi::sat16(xB + tr[R_BM * Mp + k]);
        sv = max(sv, bi::sat16((j ? dm[j - 1] : mp) + tr[R_MM * Mp + k]));
        sv = max(sv, bi::sat16((j ? di[j - 1] : ip) + tr[R_IM * Mp + k]));
        sv = max(sv, bi::sat16((j ? dd[j - 1] : dpv) + tr[R_DM * Mp + k]));
        sv = bi::sat16(sv + e[j]);
        di[j] = max(bi::sat16(dm[j] + tr[R_MI * Mp + k]),
                    bi::sat16(di[j] + tr[R_II * Mp + k]));
        dm[j] = sv;
        if (k < M) xE = max(xE, sv);
      }
      xE = bi::group_max(g, xE);
      const bool ovf2 = xE >= 32767;
      if (CAPTURE) {
        if (xE >= th && !ovf2) {  // the same on every thread of the group
          int ord = 8 * Q;
#pragma unroll
          for (int j = 0; j < P; ++j) {
            const int k = k0 + j;
            if (k < M && dm[j] == xE) ord = min(ord, (k % Q) * 8 + k / Q);
          }
          ord = bi::group_min(g, ord);
          if (g.t == 0) krow[i] = (int16_t)((ord % 8) * Q + ord / 8 + 1);
        }
        if (ovf2 && ovfrow == 0) ovfrow = i + 1;
      }
      // D row: part[k] = sat(M[k-1] + tMD[k]), closed along k by the map
      // scan; the parts wait in dd
      const int svprev = bi::lane_before(g, dm[P - 1], bi::NEG);
      bi::MaxPlus run{0, bi::NEG};
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int k = k0 + j;
        dd[j] = bi::sat16((j ? dm[j - 1] : svprev) + tr[R_MDS * Mp + k]);
        run = bi::mp_then(run, bi::MaxPlus{tr[R_DDS * Mp + k], dd[j]});
      }
      int y = bi::group_scan_excl(g, run).b;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        y = max(dd[j], bi::sat16(y + tr[R_DDS * Mp + k0 + j]));
        dd[j] = y;
      }
      xC = max(xC, xE + emove);
      xJ = max(xJ, xE + eloop);
      xB = bi::sat16(max(xJ, base) + mv);
      ovf |= ovf2;
      if (i == len - 1) {
        score = xC + mv;
        has = xC > bi::NEG;
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
}

// One launch: blk, order and scal null for a single model (the grid is
// the plan's); else `nblocks` blocks, one per row of blk, each of at
// most `per_block` items, which must be the plan's.
template <bool CAPTURE>
static int vit_launch(const void* flat, const void* offs, const void* lens,
                      const void* move, const void* thresh, int B,
                      const void* tab, int Kp, int M, int Mp, int P, int base,
                      int emove, int eloop, void* out, void* karr,
                      const void* blk, const void* order, const void* scal,
                      int nblocks, int per_block, void* stream) {
  if (Mp % (32 * P) != 0 || M > Mp) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t tab_bytes = (size_t)(Kp + NTR) * Mp * sizeof(int);
#define BI_LAUNCH_VIT(PP)                                                    \
  {                                                                          \
    const BiLaunch l =                                                       \
        bi_plan(vit_filter_kernel<PP, CAPTURE>, B, Mp, PP, tab_bytes);       \
    if (blk != nullptr && per_block != l.G) return cudaErrorInvalidValue;    \
    vit_filter_kernel<PP, CAPTURE>                                           \
        <<<blk != nullptr ? nblocks : l.blocks, l.threads, l.smem, st>>>(    \
            (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,     \
            (const int*)move, (const int*)thresh, B, (const int*)tab, Kp, M, \
            Mp, l.W, l.in_smem, base, emove, eloop, (int*)out,               \
            (int16_t*)karr, (const int*)blk, (const int*)order,              \
            (const int*)scal);                                               \
  }
  BI_DISPATCH_P(P, BI_LAUNCH_VIT)
#undef BI_LAUNCH_VIT
  return (int)cudaGetLastError();
}

// flat [N] int8 residues; offs [B] int64, lens and move [B] int32 per
// ORF; tab [Kp + 8, Mp] int32: the match words rwv [Kp, Mp], then the
// eight transition rows (ops/vit.py R_*), -32768 past the model;
// out [3, B] int32: score_int, has, ovf.  Returns the launch's
// cudaError_t.
extern "C" int bt_vit_filter(const void* flat, const void* offs,
                             const void* lens, const void* move, int B,
                             const void* tab, int Kp, int M, int Mp, int P,
                             int base, int emove, int eloop, void* out,
                             void* stream) {
  if (B <= 0) return 0;
  return vit_launch<false>(flat, offs, lens, move, nullptr, B, tab, Kp, M, Mp,
                           P, base, emove, eloop, out, nullptr, nullptr,
                           nullptr, nullptr, 0, 0, stream);
}

// The multi-model entry of bt_vit_filter: tab [G, Kp + 8, Mp] stacks the
// tables of the models of padded width Mp and scal [G, 4] int32 holds
// each one's M, base, emove, eloop; blk [nblocks, 3] int32 = (model,
// first, count) per block and order [.] int32 the item rows
// (bi::block_items).  out [3, B] is written at the listed items only.
extern "C" int bt_vit_filter_multi(const void* flat, const void* offs,
                                   const void* lens, const void* move, int B,
                                   const void* tab, const void* scal, int Kp,
                                   int Mp, int P, void* out, const void* blk,
                                   const void* order, int nblocks,
                                   int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (blk == nullptr || order == nullptr || scal == nullptr)
    return cudaErrorInvalidValue;
  return vit_launch<false>(flat, offs, lens, move, nullptr, B, tab, Kp, 0, Mp,
                           P, 0, 0, 0, out, nullptr, blk, order, scal, nblocks,
                           per_block, stream);
}

// As bt_vit_filter, with thresh [B] int32 per ORF; out [B] int32: the
// first saturated row (1-based, 0 if none); karr [N] int16 in the layout
// of flat, zeroed by the caller: the striped-order k_start at each
// crossing row.  Returns the launch's cudaError_t.
extern "C" int bt_vit_capture(const void* flat, const void* offs,
                              const void* lens, const void* move,
                              const void* thresh, int B, const void* tab,
                              int Kp, int M, int Mp, int P, int base,
                              int emove, int eloop, void* out, void* karr,
                              void* stream) {
  if (B <= 0) return 0;
  return vit_launch<true>(flat, offs, lens, move, thresh, B, tab, Kp, M, Mp,
                          P, base, emove, eloop, out, karr, nullptr, nullptr,
                          nullptr, 0, 0, stream);
}
