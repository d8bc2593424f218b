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
// 128-lane padding into xEu).
//
// What bounds it on the H100: a flush is ~65k short ORFs (mean ~40
// residues), each a chain of dependent rows of ~10 byte operations per
// model lane and one warp-wide max (xE feeds the next row's xB).  Integer
// ALU throughput and the row latency bound it; the table (SSV byte and MSV
// cost packed in one int per lane) lives in shared memory, read with an
// odd stride P per thread, free of bank conflicts.  The design answers
// with one warp per ORF, eight to a block, blocks striding over the
// ORFs so the table is loaded once per block.
//
// The multi-model entry bt_msv_filter_multi replaces the MSV half of
// bath_tpu/evalues_device.py _dyn_kernels (the vmap of _ssv_msv_mb_impl
// over models with base/tec/tbm/bias as traced values): item b is
// filtered under model slot[b].  It is this same kernel, so the same
// arithmetic item for item; the models' tables of one padded width Mp
// are stacked [G, Kp, Mp], a block finds its model and its items in a
// per-block table (bi::block_items) and reads that model's M, base, tec,
// tbm and bias from one row of scal [G, 5]; one launch per Mp.  Items
// are read at their own offsets, so the models of a calibration share
// one copy of the simulated batch (offsets repeat).  The same bound
// holds: integer ALU throughput and the row chain.

#include "int_common.cuh"

template <int P>
__global__ void msv_filter_kernel(const int8_t* __restrict__ flat,
                                  const int64_t* __restrict__ offs,
                                  const int* __restrict__ lens,
                                  const int* __restrict__ tjb, int B,
                                  const int* __restrict__ tab_g, int Kp, int M,
                                  int Mp, int W, bool in_smem, int base,
                                  int tec, int tbm, int bias,
                                  int* __restrict__ out,
                                  const int* __restrict__ blk,
                                  const int* __restrict__ order,
                                  const int* __restrict__ scal) {
  extern __shared__ int smem[];
  const bi::Items it = bi::block_items(blk, B, W);
  if (blk != nullptr) {  // this block's model: its scalars and its table
    const int* s = scal + 5 * it.model;
    M = s[0];
    base = s[1];
    tec = s[2];
    tbm = s[3];
    bias = s[4];
  }
  const int* tab = bi::load_table(tab_g + (size_t)it.model * Kp * Mp, Kp * Mp,
                                  smem, in_smem);
  const bi::Group g = bi::make_group(W, smem + (in_smem ? Kp * Mp : 0));
  const int k0 = g.t * P;
  for (int q = it.first; q < it.end; q += it.step) {
    const int b = blk != nullptr ? order[q] : q;
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
      const int* e = tab + (int)seq[i] * Mp + k0;
      // the previous row's SSV and MSV cells at lane k0-1, in one word
      const int pv = bi::lane_before(g, (d[P - 1] & 0xFF) | (dp[P - 1] << 8),
                                     0x80);
      const int dprev = ((pv & 0xFF) ^ 0x80) - 0x80;
      const int mprev = pv >> 8;
      int xE = 0;
      // in place, high lane first: lane j reads lane j-1's old cells
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        const int ent = e[j];
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
      xE = bi::group_max(g, xE);
      movf |= xE + bias >= 255;
      xJ = max(xJ, max(0, xE - tec));
      xB = max(0, max(base, xJ) - tjbm);
    }
    umax = bi::group_max(g, umax);
    if (g.t == 0) {
      out[b] = umax;
      out[B + b] = xJ;
      out[2 * B + b] = movf;
    }
  }
}

// One launch: blk, order and scal null for a single model (the grid is
// the plan's); else `nblocks` blocks, one per row of blk, each of at
// most `per_block` items, which must be the plan's.
static int msv_launch(const void* flat, const void* offs, const void* lens,
                      const void* tjb, int B, const void* tab, int Kp, int M,
                      int Mp, int P, int base, int tec, int tbm, int bias,
                      void* out, const void* blk, const void* order,
                      const void* scal, int nblocks, int per_block,
                      void* stream) {
  if (Mp % (32 * P) != 0 || M > Mp) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t tab_bytes = (size_t)Kp * Mp * sizeof(int);
#define BI_LAUNCH_MSV(PP)                                                    \
  {                                                                          \
    const BiLaunch l = bi_plan(msv_filter_kernel<PP>, B, Mp, PP, tab_bytes); \
    if (blk != nullptr && per_block != l.G) return cudaErrorInvalidValue;    \
    msv_filter_kernel<PP>                                                    \
        <<<blk != nullptr ? nblocks : l.blocks, l.threads, l.smem, st>>>(    \
            (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,     \
            (const int*)tjb, B, (const int*)tab, Kp, M, Mp, l.W, l.in_smem,  \
            base, tec, tbm, bias, (int*)out, (const int*)blk,                \
            (const int*)order, (const int*)scal);                            \
  }
  BI_DISPATCH_P(P, BI_LAUNCH_MSV)
#undef BI_LAUNCH_MSV
  return (int)cudaGetLastError();
}

// flat [N] int8 residues; offs [B] int64, lens [B] int32, tjb [B] int32
// per ORF; tab [Kp, Mp] int32 (SSV byte in bits 0-7, MSV cost in bits
// 8-15; 127/255 past the model); out [3, B] int32: xEu, xJm, movf.
// Returns the launch's cudaError_t.
extern "C" int bt_msv_filter(const void* flat, const void* offs,
                             const void* lens, const void* tjb, int B,
                             const void* tab, int Kp, int M, int Mp, int P,
                             int base, int tec, int tbm, int bias, void* out,
                             void* stream) {
  if (B <= 0) return 0;
  return msv_launch(flat, offs, lens, tjb, B, tab, Kp, M, Mp, P, base, tec,
                    tbm, bias, out, nullptr, nullptr, nullptr, 0, 0, stream);
}

// The multi-model entry: tab [G, Kp, Mp] stacks the tables of the models
// of padded width Mp and scal [G, 5] int32 holds each one's M, base,
// tec, tbm, bias; blk [nblocks, 3] int32 = (model, first, count) per
// block and order [.] int32 the item rows (bi::block_items).  out
// [3, B] is written at the listed items only.
extern "C" int bt_msv_filter_multi(const void* flat, const void* offs,
                                   const void* lens, const void* tjb, int B,
                                   const void* tab, const void* scal, int Kp,
                                   int Mp, int P, void* out, const void* blk,
                                   const void* order, int nblocks,
                                   int per_block, void* stream) {
  if (nblocks <= 0) return 0;
  if (blk == nullptr || order == nullptr || scal == nullptr)
    return cudaErrorInvalidValue;
  return msv_launch(flat, offs, lens, tjb, B, tab, Kp, 0, Mp, P, 0, 0, 0, 0,
                    out, blk, order, scal, nblocks, per_block, stream);
}
