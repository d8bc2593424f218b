// Microbenchmarks of the H100's own costs: the four questions that
// scripts/ubench_vpu.py asks of the TPU, asked of this card with the
// same functions, types and outputs, at the script's shapes (a
// [Mt, Bt] = [136, 1024] f32 tile, REPS = 512 steps a call).  The gate
// kernels (fwd_parser.cu, fs3_parser.cu, ...) are latency chains of
// dependent rows that read emissions by index and rescale every row;
// these five entries measure the pieces of such a row in isolation.
//
// Replaces the four TPU kernels of scripts/ubench_vpu.py:
//   bt_ub_chain          bench_chain   (pl.pallas_call at :68)
//   bt_ub_onehot_gather  bench_onehot  (:101), emissions read by index
//   bt_ub_onehot_mma     bench_onehot  (:101), one-hot product on the
//                        tensor cores, as the TPU gates read emissions
//   bt_ub_overlap        bench_overlap (:145)
//   bt_ub_scalars        bench_scalars (:183)
//
// The TPU kernels hold one [Mt, Bt] tile in VMEM and step it REPS times
// on one core.  Here the columns of the tile are independent for all
// REPS steps, so a thread, a warp or a block owns its columns for the
// whole call, keeps them in registers or shared memory, and nothing
// crosses blocks.  What bounds each entry on the card:
//   chain    f32 FMAs: one thread per element, v in a register, NOPS a
//            template parameter, so each step is a true dependent FMA;
//            at [136, 1024] the card holds 139 264 threads, about half
//            of its 132 x 2048 resident ones.
//   gather   shared-memory reads and f32 adds: the table transposed in
//            shared memory, a warp per column, so the 32 lanes read one
//            table column's rows side by side (no bank conflicts).
//   mma      the tensor cores through mma.sync.m16n8k16 bf16 (inline
//            PTX): per 16 columns the one-hot tile OH^T [16, n] is
//            built in registers and multiplied with t^T [n, 8] tiles
//            that sit in shared memory in fragment order.  mma.sync
//            does not reach the card's 989 TFLOP/s (only wgmma does);
//            the bound is stated against the card.
//   overlap  a block owns 32 columns: g [2Mt, 2Mt] and the yacc tile
//            [2Mt, 32] in shared memory (170 240 bytes at Mt = 136), one
//            warp per 16 rows of g @ yacc on the tensor cores, and the
//            acc chain of the same columns on the CUDA cores, 8
//            elements a thread.  Whether the SM overlaps the two is
//            what t(both) against max(t(chain), t(dot)) shows.
//   scalars  one thread per column, the 16 rows in registers: on this
//            card a [1, Bt] row is Bt lanes like any other row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMt = 136;         // rows a gather/mma call takes
constexpr int kOverlapCols = 32;    // columns of an overlap block

// ---------------------------------------------------------------------
// #7: REPS x { NOPS x (v = v*v + 0.25); v *= 0.5 } per element
// ---------------------------------------------------------------------
template <int NOPS>
__global__ void ub_chain_kernel(const float* __restrict__ x,
                                float* __restrict__ out, int n, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < NOPS; ++k) v = fmaf(v, v, 0.25f);
    v *= 0.5f;
  }
  out[i] = v;
}

// ---------------------------------------------------------------------
// #8, by index: acc[m, b] = sum_i t[m, idx[i, b]], i in rep order
// ---------------------------------------------------------------------
// ts [n][Mtp] bf16 (Mtp = Mt rounded up to 2, zero row past Mt): a
// warp owns column b; lane l reads the row pairs 2p, 2p+1 with
// p = l + 32j.  The indices of 32 reps travel one to a lane and are
// broadcast by shuffle; the next 32 are loaded while these are used.
// An index outside [0, n) adds nothing (in the mma entry it matches no
// row of the one-hot tile), so the wrapper need not read the indices
// back to check them.
__global__ void ub_onehot_gather_kernel(const __nv_bfloat16* __restrict__ t,
                                        const int* __restrict__ idx,
                                        float* __restrict__ out, int Mt,
                                        int n, int Bt, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ts = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int Mtp = (Mt + 1) & ~1;
  for (int e = threadIdx.x; e < n * Mtp; e += blockDim.x) {
    const int k = e / Mtp, m = e % Mtp;
    ts[e] = m < Mt ? t[(size_t)m * n + k] : __float2bfloat16(0.f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= Bt) return;
  constexpr int NJ = (kMaxMt / 2 + 31) / 32;
  const int half = Mtp / 2;
  const __nv_bfloat162* ts2 = reinterpret_cast<const __nv_bfloat162*>(ts);
  float acc[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = 0.f;
  int nxt = lane < reps ? idx[(size_t)lane * Bt + b] : 0;
  for (int i0 = 0; i0 < reps; i0 += 32) {
    const int cur = nxt;
    if (i0 + 32 + lane < reps) nxt = idx[(size_t)(i0 + 32 + lane) * Bt + b];
    const int cnt = reps - i0 < 32 ? reps - i0 : 32;
    for (int r = 0; r < cnt; ++r) {
      const int k = __shfl_sync(0xffffffffu, cur, r);
      if ((unsigned)k >= (unsigned)n) continue;   // adds nothing
      const __nv_bfloat162* row = ts2 + (size_t)k * half;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = lane + 32 * j;
        if (p < half) {
          const float2 f = __bfloat1622float2(row[p]);
          acc[j][0] += f.x;
          acc[j][1] += f.y;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int m = 2 * (lane + 32 * j);
    if (m < Mt) out[(size_t)m * Bt + b] = acc[j][0];
    if (m + 1 < Mt) out[(size_t)(m + 1) * Bt + b] = acc[j][1];
  }
}

// ---------------------------------------------------------------------
// The tensor-core product: D[16, 8] += A[16, 16] B[16, 8], bf16 in,
// f32 accumulate.  Fragments (PTX ISA, mma.m16n8k16, g = lane / 4,
// q = lane % 4; the lower half of a register holds the element of the
// lower column (A) or row (B)):
//   a0 (g, 2q..2q+1)  a1 (g+8, 2q..)  a2 (g, 2q+8..)  a3 (g+8, 2q+8..)
//   b0 (2q..2q+1, g)  b1 (2q+8.., g)
//   d0, d1 (g, 2q..2q+1)  d2, d3 (g+8, 2q..2q+1)
// ---------------------------------------------------------------------
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The one-hot pair of a row whose index sits d past the pair's first
// column: 1.0 (bf16 0x3F80) in the half that holds it.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return d == 0 ? 0x00003F80u : d == 1 ? 0x3F800000u : 0u;
}

// ---------------------------------------------------------------------
// #8, one-hot product: acc^T[b, m] += OH^T[b, k] t^T[k, m] per rep
// ---------------------------------------------------------------------
// A block of 4 warps owns 16 columns; warp w takes the m-tiles (8 rows
// of t each) w, w+4, ..., w+16.  frag[kt][mt][lane] holds the B operand
// (t^T) of k-tile kt, m-tile mt in fragment order, zero past n and Mt.
// The indices: lane l loads column c0 + l % 16 of reps i0 + l / 16 + 2j
// (j < 8), 16 reps a chunk; a rep's two columns g, g+8 come by shuffle.
constexpr int kMmaWarps = 4;
constexpr int kMmaTiles = (kMaxMt / 8 + kMmaWarps - 1) / kMmaWarps;

__global__ void ub_onehot_mma_kernel(const __nv_bfloat16* __restrict__ t,
                                     const int* __restrict__ idx,
                                     float* __restrict__ out, int Mt, int n,
                                     int Bt, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* frag = reinterpret_cast<uint2*>(smem_raw);
  const int KT = (n + 15) / 16, MT = (Mt + 7) / 8;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int e = threadIdx.x; e < KT * MT * 32; e += blockDim.x) {
    const int l = e & 31, mt = (e >> 5) % MT, kt = (e >> 5) / MT;
    const int m = mt * 8 + (l >> 2), k = kt * 16 + 2 * (l & 3);
    __nv_bfloat16 v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int kk = k + (h & 1) + 8 * (h >> 1);
      v[h] = (m < Mt && kk < n) ? t[(size_t)m * n + kk] : zero;
    }
    frag[e] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int c0 = blockIdx.x * 16;
  float acc[kMmaTiles][4];
#pragma unroll
  for (int j = 0; j < kMmaTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int* col = idx + c0 + (lane & 15);
  int nxt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int i = (lane >> 4) + 2 * j;
    nxt[j] = i < reps ? col[(size_t)i * Bt] : -1;
  }
  for (int i0 = 0; i0 < reps; i0 += 16) {
    int cur[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      cur[j] = nxt[j];
      const int i = i0 + 16 + (lane >> 4) + 2 * j;
      if (i < reps) nxt[j] = col[(size_t)i * Bt];
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      if (i0 + r >= reps) break;
      const int src = (r & 1) << 4;
      const int k0 = __shfl_sync(0xffffffffu, cur[r >> 1], src | g) - 2 * q;
      const int k1 = __shfl_sync(0xffffffffu, cur[r >> 1], src | (g + 8)) -
                     2 * q;
      for (int kt = 0; kt < KT; ++kt) {
        const int d0 = k0 - 16 * kt, d1 = k1 - 16 * kt;
        const uint32_t a0 = onehot_pair(d0), a1 = onehot_pair(d1);
        const uint32_t a2 = onehot_pair(d0 - 8), a3 = onehot_pair(d1 - 8);
        const uint2* fk = frag + (size_t)kt * MT * 32 + lane;
#pragma unroll
        for (int j = 0; j < kMmaTiles; ++j) {
          const int mt = warp + kMmaWarps * j;
          if (mt < MT) {
            const uint2 bf = fk[mt * 32];
            mma_bf16(acc[j], a0, a1, a2, a3, bf.x, bf.y);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMmaTiles; ++j) {
    const int m = (warp + kMmaWarps * j) * 8 + 2 * q;
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int mm = m + (h & 1), b = c0 + g + 8 * (h >> 1);
      if (mm < Mt) out[(size_t)mm * Bt + b] = acc[j][h];
    }
  }
}

// ---------------------------------------------------------------------
// #9: per rep, yacc <- bf16((1e-3 g @ yacc)^2 + 0.25) [2Mt, Bt] and
// acc <- 12 x (v*v + 0.25), then * 0.5 [Mt, Bt]; out = acc + yacc[:Mt]
// ---------------------------------------------------------------------
// gs [2Mt][S] and ys [32][S] bf16, S = 2Mt + 8 (row words = 4 mod 8:
// the fragment loads hit 32 banks); ys holds the yacc tile by column,
// so both operands load as 32-bit pairs along k.  Warp w computes rows
// 16w..16w+15 of g @ yacc for the block's 4 n-tiles.  yacc starts at
// 0.3, as in the script, or at y0 [2Mt, Bt] when given (a start whose
// columns differ, so that a check can see the columns' mapping).
template <bool CHAIN, bool DOT>
__global__ void ub_overlap_kernel(const __nv_bfloat16* __restrict__ g_in,
                                  const float* __restrict__ x,
                                  const __nv_bfloat16* __restrict__ y0,
                                  float* __restrict__ out, int Mt, int Bt,
                                  int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M2 = 2 * Mt, S = M2 + 8;
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ys = gs + (size_t)M2 * S;
  const int c0 = blockIdx.x * kOverlapCols;
  for (int e = threadIdx.x; e < M2 * M2; e += blockDim.x)
    gs[(e / M2) * S + e % M2] = g_in[e];
  for (int e = threadIdx.x; e < kOverlapCols * M2; e += blockDim.x) {
    const int c = e / M2, m = e % M2;
    ys[c * S + m] = y0 ? y0[(size_t)m * Bt + c0 + c] : __float2bfloat16(0.3f);
  }
  // the chain: elements e = tid + j * threads of the [Mt, 32] tile
  constexpr int NE = 8;          // Mt * 32 / (32 * Mt / 8) a thread
  float v[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    v[j] = x[(size_t)(e / kOverlapCols) * Bt + c0 + e % kOverlapCols];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const uint32_t* g32 = reinterpret_cast<const uint32_t*>(gs);
  const uint32_t* y32 = reinterpret_cast<const uint32_t*>(ys);
  const int S2 = S / 2;
  for (int r = 0; r < reps; ++r) {
    float d[4][4];
    if (DOT) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) d[nt][0] = d[nt][1] = d[nt][2] =
          d[nt][3] = 0.f;
      const uint32_t* ga = g32 + (16 * warp + gq) * S2 + q;
      for (int kt = 0; kt < M2 / 16; ++kt) {
        const uint32_t a0 = ga[8 * kt], a1 = ga[8 * S2 + 8 * kt];
        const uint32_t a2 = ga[8 * kt + 4], a3 = ga[8 * S2 + 8 * kt + 4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t* yb = y32 + (8 * nt + gq) * S2 + 8 * kt + q;
          mma_bf16(d[nt], a0, a1, a2, a3, yb[0], yb[4]);
        }
      }
    }
    if (CHAIN) {
#pragma unroll
      for (int j = 0; j < NE; ++j) {
#pragma unroll
        for (int k = 0; k < 12; ++k) v[j] = fmaf(v[j], v[j], 0.25f);
        v[j] *= 0.5f;
      }
    }
    if (DOT) {
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int m = 16 * warp + gq + 8 * (h >> 1);
          const int c = 8 * nt + 2 * q + (h & 1);
          const float y = d[nt][h] * 1e-3f;
          ys[c * S + m] = __float2bfloat16(y * y + 0.25f);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int e = threadIdx.x + j * blockDim.x;
    const int m = e / kOverlapCols, c = e % kOverlapCols;
    out[(size_t)m * Bt + c0 + c] = v[j] + __bfloat162float(ys[c * S + m]);
  }
}

// ---------------------------------------------------------------------
// #10: sp [32, Bt] from 0.3; REPS x (rows 0-7 one by one, rows 8-15 as
// a block) v*v + 0.25; out = row 0.  The rows are read from the scratch
// the wrapper filled with 0.3 (loaded, not constants, so the compiler
// cannot merge the 16 identical rows into one) and written back.
// ---------------------------------------------------------------------
__global__ void ub_scalars_kernel(float* __restrict__ sp,
                                  float* __restrict__ out, int Bt,
                                  int reps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= Bt) return;
  float row[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) row[r] = sp[(size_t)r * Bt + b];
  for (int i = 0; i < reps; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) row[r] = fmaf(row[r], row[r], 0.25f);
#pragma unroll
    for (int r = 8; r < 16; ++r) row[r] = fmaf(row[r], row[r], 0.25f);
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) sp[(size_t)r * Bt + b] = row[r];
  out[b] = row[0];
}

int opt_in(const void* kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  return 0;
}

}  // namespace

// x, out [n] f32.  nops 4 or 16.
extern "C" int bt_ub_chain(const void* x, void* out, int n, int nops,
                           int reps, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256, blocks = (n + threads - 1) / threads;
  if (nops == 4)
    ub_chain_kernel<4><<<blocks, threads, 0, st>>>((const float*)x,
                                                   (float*)out, n, reps);
  else if (nops == 16)
    ub_chain_kernel<16><<<blocks, threads, 0, st>>>((const float*)x,
                                                    (float*)out, n, reps);
  else
    return cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// t [Mt, n] bf16, idx [reps, Bt] int32 in [0, n), out [Mt, Bt] f32;
// Mt <= 136.
extern "C" int bt_ub_onehot_gather(const void* t, const void* idx,
                                   void* out, int Mt, int n, int Bt,
                                   int reps, void* stream) {
  if (Mt <= 0 || Mt > kMaxMt || n <= 0 || Bt <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)n * ((Mt + 1) & ~1) * 2;
  const int err = opt_in((const void*)ub_onehot_gather_kernel, smem);
  if (err) return err;
  const int warps = 8;
  ub_onehot_gather_kernel<<<(Bt + warps - 1) / warps, 32 * warps, smem,
                            st>>>((const __nv_bfloat16*)t, (const int*)idx,
                                  (float*)out, Mt, n, Bt, reps);
  return (int)cudaGetLastError();
}

// The same function and shapes; Bt a multiple of 16.
extern "C" int bt_ub_onehot_mma(const void* t, const void* idx, void* out,
                                int Mt, int n, int Bt, int reps,
                                void* stream) {
  if (Mt <= 0 || Mt > kMaxMt || n <= 0 || Bt <= 0 || Bt % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem =
      (size_t)((n + 15) / 16) * ((Mt + 7) / 8) * 32 * sizeof(uint2);
  const int err = opt_in((const void*)ub_onehot_mma_kernel, smem);
  if (err) return err;
  ub_onehot_mma_kernel<<<Bt / 16, 32 * kMmaWarps, smem, st>>>(
      (const __nv_bfloat16*)t, (const int*)idx, (float*)out, Mt, n, Bt,
      reps);
  return (int)cudaGetLastError();
}

// g [2Mt, 2Mt] bf16, x and out [Mt, Bt] f32, y0 [2Mt, Bt] bf16 or
// null (yacc from 0.3); mode 1 chain, 2 dot, 3 both; Mt a multiple of
// 8, Bt of 32.
extern "C" int bt_ub_overlap(const void* g, const void* x, const void* y0,
                             void* out, int Mt, int Bt, int mode, int reps,
                             void* stream) {
  if (Mt <= 0 || Mt % 8 || Bt <= 0 || Bt % kOverlapCols)
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(2 * Mt + kOverlapCols) * (2 * Mt + 8) * 2;
  const int threads = 4 * Mt;     // a warp per 16 rows of g
  const int blocks = Bt / kOverlapCols;
#define UB_OVERLAP(C, D)                                                     \
  {                                                                          \
    const int err = opt_in((const void*)ub_overlap_kernel<C, D>, smem);      \
    if (err) return err;                                                     \
    ub_overlap_kernel<C, D><<<blocks, threads, smem, st>>>(                  \
        (const __nv_bfloat16*)g, (const float*)x,                           \
        (const __nv_bfloat16*)y0, (float*)out, Mt, Bt, reps);                \
  }
  if (mode == 1)
    UB_OVERLAP(true, false)
  else if (mode == 2)
    UB_OVERLAP(false, true)
  else if (mode == 3)
    UB_OVERLAP(true, true)
  else
    return cudaErrorInvalidValue;
#undef UB_OVERLAP
  return (int)cudaGetLastError();
}

// sp [32, Bt] f32 scratch filled with 0.3 by the caller (rows 0-15 are
// stepped in place), out [Bt] f32.
extern "C" int bt_ub_scalars(void* sp, void* out, int Bt, int reps,
                             void* stream) {
  if (Bt <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  ub_scalars_kernel<<<(Bt + threads - 1) / threads, threads, 0, st>>>(
      (float*)sp, (float*)out, Bt, reps);
  return (int)cudaGetLastError();
}
