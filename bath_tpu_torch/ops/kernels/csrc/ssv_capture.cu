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
// takes one warp max; only a row that crosses the threshold takes the
// second, a warp min of the striped order (stripes of 16,
// Q = max(2, ceil(M/16))) over the lanes holding that max.
//
// What bounds it on the H100: the same row chain as msv_filter.cu with
// half its byte work; the bias survivors it sees are few thousand per
// flush, so the launch is short and one warp per ORF keeps it simple.
// It reads MSV's int16 table (warp-transposed, int_common.cuh lane_at).

#include "int_common.cuh"

constexpr int NCAP = 16;

template <int P>
__global__ void ssv_capture_kernel(const int8_t* __restrict__ flat,
                                   const int64_t* __restrict__ offs,
                                   const int* __restrict__ lens,
                                   const int* __restrict__ tjb,
                                   const int* __restrict__ thresh, int B,
                                   const uint16_t* __restrict__ tab_g, int Kp,
                                   int M, int Mp, int W, bool in_smem, int base,
                                   int tbm, int bias, int* __restrict__ nwin_o,
                                   int* __restrict__ caps) {
  extern __shared__ int4 smem4[];
  const size_t tab_bytes = (size_t)Kp * Mp * sizeof(uint16_t);
  const uint16_t* tab = tab_g;
  if (in_smem) {
    bi::stage_words(tab_g, tab_bytes, smem4);
    tab = reinterpret_cast<const uint16_t*>(smem4);
  }
  const bi::Group g = bi::make_group(
      W, reinterpret_cast<int*>(reinterpret_cast<char*>(smem4) +
                                (in_smem ? tab_bytes : 0)));
  const uint16_t* ew = tab + g.warp * 32 * P + g.lane;
  const int G = blockDim.x / (32 * W);
  const int k0 = g.t * P;
  const int Q = max(2, (M + 15) / 16);
  for (int b = blockIdx.x * G + (threadIdx.x >> 5) / W; b < B;
       b += gridDim.x * G) {
    const int len = lens[b];
    const int xB = max(0, base - (tjb[b] + tbm));
    const int th = thresh[b];
    const int8_t* seq = flat + offs[b];
    int dp[P];
#pragma unroll
    for (int j = 0; j < P; ++j) dp[j] = 0;
    int nwin = 0;
    for (int i = 0; i < len; ++i) {
      const uint16_t* e = ew + (int)seq[i] * Mp;
      const int mprev = bi::lane_before(g, dp[P - 1], 0);
      int best = 0;
#pragma unroll
      for (int j = P - 1; j >= 0; --j) {
        int sv = max(j ? dp[j - 1] : mprev, xB);
        sv = max(min(sv + bias, 255) - ((int)e[32 * j] >> 8), 0);
        dp[j] = k0 + j < M ? sv : 0;
        best = max(best, dp[j]);
      }
      const int msc = bi::group_max(g, best);
      if (msc >= th) {  // the same on every thread of the group
        int ord = 16 * Q;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const int k = k0 + j;
          if (k < M && dp[j] == msc) ord = min(ord, (k % Q) * 16 + k / Q);
          dp[j] = 0;
        }
        ord = bi::group_min(g, ord);
        if (g.t == 0 && nwin < NCAP) {
          int* c = caps + (size_t)b * NCAP + nwin;
          c[0] = i + 1;
          c[(size_t)B * NCAP] = (ord % 16) * Q + ord / 16 + 1;
          c[2 * (size_t)B * NCAP] = msc;
        }
        ++nwin;
      }
    }
    if (g.t == 0) nwin_o[b] = nwin;
  }
}

// flat [N] int8 residues; offs [B] int64, lens, tjb and thresh [B] int32
// per ORF; tab [Kp, Mp] int16, warp-transposed (MSV cost in bits 8-15,
// 255 past the model; ops/ssv.py MSVParams.kernel_table); nwin [B]
// int32; caps [3, B, 16] int32 (row, k, score), zeroed by the caller.
// Returns the launch's cudaError_t.
extern "C" int bt_ssv_capture(const void* flat, const void* offs,
                              const void* lens, const void* tjb,
                              const void* thresh, int B, const void* tab,
                              int Kp, int M, int Mp, int P, int base, int tbm,
                              int bias, void* nwin, void* caps, void* stream) {
  if (B <= 0) return 0;
  if (Mp % (32 * P) != 0 || M > Mp) return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t tab_bytes = (size_t)Kp * Mp * sizeof(uint16_t);
#define BI_LAUNCH_SSVCAP(PP)                                                 \
  {                                                                          \
    const BiLaunch l = bi_plan(ssv_capture_kernel<PP>, B, Mp, PP, tab_bytes);\
    ssv_capture_kernel<PP><<<l.blocks, l.threads, l.smem, st>>>(             \
        (const int8_t*)flat, (const int64_t*)offs, (const int*)lens,         \
        (const int*)tjb, (const int*)thresh, B, (const uint16_t*)tab, Kp, M, \
        Mp, l.W, l.in_smem, base, tbm, bias, (int*)nwin, (int*)caps);        \
  }
  BI_DISPATCH_P(P, BI_LAUNCH_SSVCAP)
#undef BI_LAUNCH_SSVCAP
  return (int)cudaGetLastError();
}
