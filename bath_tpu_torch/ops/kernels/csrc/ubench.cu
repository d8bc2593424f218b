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
//                        tensor cores (wgmma), as the TPU gates read
//                        emissions
//   bt_ub_overlap        bench_overlap (:145)
//   bt_ub_scalars        bench_scalars (:183)
//
// The TPU kernels hold one [Mt, Bt] tile in VMEM and step it REPS times
// on one core.  Here the columns of the tile are independent for all
// REPS steps, so a thread, a warp or a warpgroup owns its columns for
// the whole call and keeps them in registers or shared memory.  What
// bounds each entry on the card:
//   chain    f32 FMAs: one thread per element, v in a register, NOPS a
//            template parameter, so each step is a true dependent FMA;
//            at [136, 1024] the card holds 139 264 threads, about half
//            of its 132 x 2048 resident ones.
//   gather   shared-memory reads, unpacks and f32 adds issued: t^T's
//            padded image (made once a call) in shared memory, 16
//            threads a column at Mt = 136, each 8 rows by one 16-byte
//            load a step, the row offsets staged a warp at a time.
//   mma      the tensor cores through wgmma (inline PTX, the only path
//            to their full rate): a warpgroup owns 64 columns, builds
//            each step's one-hot tile OH^T [64, n] in registers as A and
//            multiplies it with t^T in shared memory (B), n padded to
//            16 KT (KT = 2, 5, 17 instructions a step); the steps are
//            split over blocks to fill the card (16 tiles at Bt = 1024)
//            and the partial sums added in a fixed order.
//   overlap  a block owns 64 columns: G^T (B) in shared memory, Y^T (A)
//            in the product warpgroup's registers from step to step,
//            the acc chain in a second warpgroup; the product's floor
//            is its bf16 work on the SMs that hold a tile, one a tile
//            (2 x 272^2 x 64 x REPS operations at 989/132 TFLOP/s an
//            SM: 0.647 ms at REPS = 512, for Bt = 1024 and 4096 alike).
//            Whether the SM overlaps the two is what t(both) against
//            max(t(chain), t(dot)) shows.
//   scalars  the latency of one dependent FMA chain: a thread for each
//            of the 16 x Bt stepped elements, spread over the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMt = 136;         // rows a gather/mma call takes

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

// Shared-memory addresses and cp.async (sm_80+), for the entries below.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------
// #8, by index: acc[m, b] = sum_i t[m, idx[i, b]], i in step order
// ---------------------------------------------------------------------
// Each element's sum stays in one thread and runs in step order (f32
// adds of the bf16 entries, bit for bit the plain version's), so the
// steps cannot be split; what the design chooses is how many threads
// share a column and where their operands come from.
//
// The image: t^T, row k of the table (k < n) the Mt values t[:, k]
// padded with zeros to 8G (G = ceil(Mt / 8) groups of 8 rows, 16 bytes
// of bf16 a group), and a zero row k = n.  ub_gather_pack_kernel makes
// it once a call in a torch.empty scratch; each block copies it whole
// into shared memory, 16 bytes a cp.async.  An index outside [0, n) is
// clamped to the zero row, so no step branches: adding +0.0 leaves an
// f32 sum that starts at +0.0 as it was.
//
// The threads: TPC = min(G, 16) a column, a warp owns CW = 32 / TPC
// whole columns, lane l column l / TPC and group g = l % TPC, the rows
// 8g..8g+7, one 16-byte shared load (ld.shared.v4) a step: at Mt = 136
// (G = 17) 16 threads a column, two columns a warp, so each quarter-warp
// reads 8 consecutive groups of one row (no bank conflict), and the
// 17th group, rows 128..135, goes to the lanes g < 8, one row each (a
// 2-byte load; every lane issues it, lanes g >= 8 drop theirs).  Bt =
// 1024 is 512 warps, under one a scheduler of the 528, no lane idle.
// A step of a lane: the row's byte offset (four steps a 16-byte load),
// one add for its address, the shared load, 8 unpacks and 8 f32 adds
// (+4 for the 17th group): 22.25 instructions for 8.5 values.  The
// floor of the design, ubench.gather_floor_ms, is the larger of those
// instructions at the SMs' issue rate and the shared-memory bytes at
// 128 B a clock an SM.  What holds it above that floor on the card
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): every call's pack
// kernel, image copy and two launches (~6 us of ~17 at [136, 1024] x
// 512), and steps at about twice the issue floor, where one warp a
// scheduler waits on its own loads and its ALU-pipe unpacks.
//
// The indices: each warp stages its own columns' indices, chunks of
// kGatherChunk steps, 4-byte cp.async into a ring of two slots
// ([CW][kGatherChunk + 4] ints: the pad puts the columns in different
// banks), then each lane turns the entries it copied into the row's
// byte offset in the image (min(k, n) x the row's bytes); steps past
// reps and columns past Bt get the zero row.  The warp's lanes only
// ever wait for each other (__syncwarp): no block barrier after the
// image.  The blocks take ceil(warps / SMs) warps each (at most 16),
// so one wave fills the card.
//
// A table whose padded image does not fit a block's shared memory
// (n > 849 at Mt = 136) takes the wide instance below, the first
// design's loop: a warp a column, the table filled by each block from t.
constexpr int kGatherChunk = 64;            // steps a warp stages at once
constexpr int kGatherSlot = kGatherChunk + 4;   // ints a column of a slot
constexpr int kGatherMaxWarps = 16;

__device__ __forceinline__ void lds128(uint32_t a, uint32_t& w0,
                                       uint32_t& w1, uint32_t& w2,
                                       uint32_t& w3) {
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(w0), "=r"(w1), "=r"(w2), "=r"(w3)
      : "r"(a));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// img [(n + 1) 8G] bf16: img[k 8G + m] = t[m, k], zero past Mt and at
// k = n.
__global__ void ub_gather_pack_kernel(const __nv_bfloat16* __restrict__ t,
                                      __nv_bfloat16* __restrict__ img,
                                      int Mt, int n, int w8) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (n + 1) * w8) return;
  const int k = e / w8, m = e - k * w8;
  img[e] = (k < n && m < Mt) ? t[(size_t)m * n + k] : __float2bfloat16(0.f);
}

template <bool EXTRA>
__global__ void __launch_bounds__(32 * kGatherMaxWarps)
    ub_gather_kernel(const uint4* __restrict__ img,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int Mt, int n, int Bt, int reps, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int E = 2;                           // bytes an element
  const int tpc = min(G, 16), cw = 32 / tpc;
  const int rb = 8 * G * E;                      // bytes a row
  const int img_bytes = (n + 1) * rb;            // a multiple of 16
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = (blockIdx.x * (blockDim.x >> 5) + warp) * cw;
  int* ring = reinterpret_cast<int*>(smem_raw + img_bytes) +
              warp * 2 * cw * kGatherSlot;
  const uint32_t base = smem_addr(smem_raw);
  // chunk ch's indices into slot ch & 1: a pass of the warp copies
  // `rows` steps of its cw columns, lane l column l % cw (a copy
  // instruction's lanes read along rows of idx); steps past reps and
  // columns past Bt get n
  const int rows = 32 / cw, js = lane % cw, ss = lane / cw;
  auto load = [&](int ch) {
    int* slot = ring + ((ch & 1) * cw + js) * kGatherSlot;
    const int b = c0 + js;
    if (ss < rows)
      for (int s = ss; s < kGatherChunk; s += rows) {
        const int i = ch * kGatherChunk + s;
        if (i < reps && b < Bt)
          cp_async4(smem_addr(slot + s), idx + (size_t)i * Bt + b);
        else
          slot[s] = n;
      }
    cp_async_commit();
  };
  // the entries this lane copied, as row offsets (clamped to the zero
  // row)
  auto offsets = [&](int ch) {
    int* slot = ring + ((ch & 1) * cw + js) * kGatherSlot;
    if (ss < rows)
      for (int s = ss; s < kGatherChunk; s += rows)
        slot[s] = (int)min((unsigned)slot[s], (unsigned)n) * rb;
  };
  // the image, 16 bytes a copy, and the first chunk of indices
  for (int v = threadIdx.x; v < img_bytes / 16; v += blockDim.x)
    cp_async16(base + 16 * v, img + v);
  cp_async_commit();
  if (c0 < Bt) load(0);
  cp_async_wait<0>();
  __syncthreads();                               // the image is in
  if (c0 >= Bt) return;
  const int jc = lane / tpc, g = lane - jc * tpc;
  const int col = min(jc, cw - 1);
  const uint32_t tb = base + 8 * E * g;          // the lane's 8 rows
  const uint32_t tx = base + 128 * E + E * (g & 7);   // its row past 127
  float acc[8], accx = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = 0.f;
  // a group of 4 steps in two halves: fetch issues its shared loads
  // (4 words a step, the 17th group's value), add unpacks and sums
  // them; the loop fetches group q + 1 before it adds group q, and
  // reads group q + 2's offsets, so no load is waited for where one
  // warp holds its scheduler alone
  auto fetch = [&](const int4 o, uint32_t (&w)[4][4], uint32_t (&x)[4]) {
    const int of[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lds128(tb + of[j], w[j][0], w[j][1], w[j][2], w[j][3]);
      if (EXTRA) {
        unsigned short h;
        asm("ld.shared.u16 %0, [%1];\n" : "=h"(h) : "r"(tx + of[j]));
        x[j] = (uint32_t)h << 16;
      }
    }
  };
  auto add = [&](const uint32_t (&w)[4][4], const uint32_t (&x)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        acc[2 * v] += bf16_lo(w[j][v]);
        acc[2 * v + 1] += bf16_hi(w[j][v]);
      }
      if (EXTRA) accx += __uint_as_float(x[j]);
    }
  };
  const int nch = (reps + kGatherChunk - 1) / kGatherChunk;
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      load(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    offsets(ch);
    __syncwarp();
    const int4* so = reinterpret_cast<const int4*>(
        ring + (ch & 1) * cw * kGatherSlot + col * kGatherSlot);
    uint32_t wa[4][4], xa[4], wb[4][4], xb[4];
    int4 o = so[1];
    fetch(so[0], wa, xa);
#pragma unroll
    for (int q = 1; q < kGatherChunk / 4; q += 2) {
      const int4 o2 = so[q + 1 < kGatherChunk / 4 ? q + 1 : q];
      fetch(o, wb, xb);
      add(wa, xa);
      if (q + 1 < kGatherChunk / 4) {
        o = so[q + 2 < kGatherChunk / 4 ? q + 2 : q + 1];
        fetch(o2, wa, xa);
      }
      add(wb, xb);
    }
    __syncwarp();                                // slot ch & 1 read
  }
  const int b = c0 + jc;
  if (jc >= cw || b >= Bt) return;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (8 * g + r < Mt) out[(size_t)(8 * g + r) * Bt + b] = acc[r];
  if (EXTRA && g < 8 && 128 + g < Mt) out[(size_t)(128 + g) * Bt + b] = accx;
}

// The wide instance, for a table whose padded image does not fit: ts
// [n][Mtp] bf16 (Mtp = Mt rounded up to 2, zero row past Mt) filled by
// each block from t; a warp owns column b, lane l reads the row pairs
// 2p, 2p+1 with p = l + 32j.  The indices of 32 steps travel one to a
// lane and are broadcast by shuffle; the next 32 are loaded while these
// are used.
__global__ void ub_onehot_gather_wide_kernel(
    const __nv_bfloat16* __restrict__ t, const int* __restrict__ idx,
    float* __restrict__ out, int Mt, int n, int Bt, int reps) {
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
// The tensor cores through wgmma (sm_90a only): a warpgroup (4 warps,
// 128 threads; warp w holds rows 16w..16w+15) issues, asynchronously,
//   D[64, 136] (+)= A[64, 16] B[16, 136]
// bf16 in, f32 accumulate; A from registers, B from shared memory by a
// matrix descriptor.  Registers (PTX ISA, wgmma .m64nNk16; g = lane / 4,
// q = lane % 4; the lower half of an A register holds the lower column):
//   A: a0 (16w+g, 2q..2q+1)  a1 (16w+g+8, 2q..)  a2 (16w+g, 2q+8..)
//      a3 (16w+g+8, 2q+8..)
//   D: d[4j], d[4j+1] (16w+g, 8j+2q..8j+2q+1), d[4j+2], d[4j+3]
//      (16w+g+8, 8j+2q..), j < 17
// so the D registers of columns 16k..16k+15 are, in this order, the A
// registers of k16 slice k: one product feeds the next as its A without
// leaving the registers (FlashAttention-3's reuse of P).
// B is K-major (B[k][n] along k for each n) with no swizzle: core
// matrices of 8 rows of 16 bytes, 128 contiguous bytes each; the core
// matrix (n / 8, k / 8) of a slice sits at start + (n / 8) SBO +
// (k / 8) LBO.  The images below put the k cores of a block of 8 rows
// side by side: LBO = 128, SBO = 128 K / 8 for a K-wide image, and
// slice kt starts 256 kt bytes in.  bath_tpu_torch/ubench.py
// (kmajor_offset, wgmma_desc) mirrors the layout and the descriptor.
// ---------------------------------------------------------------------
constexpr int kWgN = 136;           // the instruction's N (kMaxMt)
constexpr int kTileCols = 64;       // columns b of a warpgroup (its M)

__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFFu) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes of shared memory made visible to the async proxy
// (wgmma's reads of B), before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator
// across the asynchronous product and its wait (CUTLASS's
// warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[68]) {
#pragma unroll
  for (int i = 0; i < 68; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A registers: built before the wgmma.fence that precedes
// their products, not sunk past it (ptxas then serializes the products).
template <int K>
__device__ __forceinline__ void fence_a(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int h = 0; h < 4; ++h) asm volatile("" : "+r"(a[k][h])::"memory");
}

// d (+)= a B[16, 136]; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[68],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67}, "
      "{%68, %69, %70, %71}, %72, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// The one-hot pair of a row whose index sits d past the pair's first
// column: 1.0 (bf16 0x3F80) in the half that holds it.
__device__ __forceinline__ uint32_t onehot_pair(int d) {
  return (unsigned)d < 2u ? 0x3F80u << (d << 4) : 0u;
}

// ---------------------------------------------------------------------
// #8, one-hot product: out^T[b, m] = sum_i OH_i[b, k] t^T[k, m]
// ---------------------------------------------------------------------
// A block is one warpgroup over 64 columns b and a split of the steps
// (blockIdx.y; `per` steps each, whole chunks of kIdxChunk).  B = t^T
// (t itself read as K-major: row m of t along k) is the [136][KP] image,
// KP = 16 KT, zero past Mt and n, that ub_onehot_pack_kernel makes once
// a call; each block copies it into shared memory 16 bytes a cp.async
// (each block filling it element by element from t, 289 dependent
// loads a thread at KT = 17, took longer than its products at
// [136, 1024]).
// Each step's A, OH_i [64, KP], is built in registers from the step's
// indices by comparison, then KT wgmmas accumulate into d, back to back,
// and wgmma.wait_group 0 ends the step before the next A is built.  Two
// sets of A with wait_group 1 (one step's product beside the next
// step's build) made ptxas serialize every wgmma (C7513: registers
// that a wgmma reads were defined while an earlier group was in flight),
// so the build of one block overlaps the products of the other block
// an SM holds (two: registers and shared memory).  The indices come in
// chunks of kIdxChunk steps x 64 columns, cp.async into a ring of two
// shared-memory slots.  An index outside [0, n) adds nothing: it matches
// a zero row of B (n <= k < KP) or no column of A.  With several splits
// each block writes its partial sum to its slice of `dst` ([splits, Mt,
// Bt]) and ub_onehot_sum_kernel adds them in split order: two calls
// give equal bits.
constexpr int kIdxChunk = 32;       // steps of indices a cp.async chunk
constexpr int kMaxKT = 17;          // n <= 272: the widest codon table

template <int KT>
__device__ __forceinline__ void onehot_step(uint32_t (&a)[KT][4],
                                            float (&d)[68], const int* row,
                                            uint32_t bs, int q) {
  const int k0 = row[0] - 2 * q, k1 = row[8] - 2 * q;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    a[kt][0] = onehot_pair(k0 - 16 * kt);
    a[kt][1] = onehot_pair(k1 - 16 * kt);
    a[kt][2] = onehot_pair(k0 - 16 * kt - 8);
    a[kt][3] = onehot_pair(k1 - 16 * kt - 8);
  }
  fence_a(a);
  wgmma_fence();
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    wgmma_m64n136k16(d, a[kt], wgmma_desc(bs + 256 * kt, 128, 256 * KT), 1);
  wgmma_commit();
}

// img [136][16 KT] bf16: t^T's K-major image, zero past Mt and n, made
// once a call in device memory; each block copies it whole.
__global__ void ub_onehot_pack_kernel(const __nv_bfloat16* __restrict__ t,
                                      __nv_bfloat16* __restrict__ img,
                                      int Mt, int n, int KP) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kWgN * KP) return;
  const int m = e / KP, k = e % KP;
  img[((m >> 3) * (KP / 8) + (k >> 3)) * 64 + (m & 7) * 8 + (k & 7)] =
      (m < Mt && k < n) ? t[(size_t)m * n + k] : __float2bfloat16(0.f);
}

template <int KT>
__global__ void __launch_bounds__(128, 2)
    ub_onehot_mma_kernel(const __nv_bfloat16* __restrict__ img,
                         const int* __restrict__ idx, float* __restrict__ dst,
                         int Mt, int Bt, int reps, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KP = 16 * KT;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* is = reinterpret_cast<int*>(smem_raw + (size_t)kWgN * KP * 2);
  constexpr int kSlot = kIdxChunk * kTileCols;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kTileCols;
  const int i0 = blockIdx.y * per;
  const int nsteps = max(0, min(reps, i0 + per) - i0);
  // B: the image, 16 bytes a copy, in the first copy group
  for (int v = tid; v < kWgN * KP / 8; v += blockDim.x)
    cp_async16(smem_addr(bs + 8 * v), img + 8 * v);
  // columns past Bt: index -1 (no copy ever writes them)
  for (int e = tid; e < 2 * kSlot; e += blockDim.x)
    if (b0 + e % kTileCols >= Bt) is[e] = -1;
  const int nch = (nsteps + kIdxChunk - 1) / kIdxChunk;
  auto load_chunk = [&](int c) {
    int* slot = is + (c & 1) * kSlot;
    for (int v = tid; v < kSlot / 4; v += blockDim.x) {
      const int r = v / (kTileCols / 4), col = 4 * (v % (kTileCols / 4));
      const int i = c * kIdxChunk + r;
      if (i < nsteps && b0 + col < Bt)
        cp_async16(smem_addr(slot + r * kTileCols + col),
                   idx + (size_t)(i0 + i) * Bt + b0 + col);
    }
    cp_async_commit();
  };
  float d[68];
#pragma unroll
  for (int j = 0; j < 68; ++j) d[j] = 0.f;
  fence_acc(d);
  uint32_t a[KT][4];
  const uint32_t base = smem_addr(bs);
  load_chunk(0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_chunk(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const int* rows = is + (c & 1) * kSlot + 16 * warp + g;
    const int cnt = min(kIdxChunk, nsteps - c * kIdxChunk);
    for (int r = 0; r < cnt; ++r) {
      onehot_step<KT>(a, d, rows + r * kTileCols, base, q);
      wgmma_wait<0>();
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  fence_acc(d);
  float* o = dst + (size_t)blockIdx.y * Mt * Bt;
#pragma unroll
  for (int j = 0; j < 17; ++j) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int m = 8 * j + 2 * q + (h & 1);
      const int b = b0 + 16 * warp + g + 8 * (h >> 1);
      if (m < Mt && b < Bt) o[(size_t)m * Bt + b] = d[4 * j + h];
    }
  }
}

// out[e] = sum over the splits k, in order, of part[k][e]
__global__ void ub_onehot_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int count,
                                     int splits) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float s = part[e];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * count + e];
  out[e] = s;
}

// ---------------------------------------------------------------------
// #9: per rep, yacc <- bf16((1e-3 g @ yacc)^2 + 0.25) [2Mt, Bt] and
// acc <- 12 x (v*v + 0.25), then * 0.5 [Mt, Bt]; out = acc + yacc[:Mt]
// ---------------------------------------------------------------------
// Transposed, a step is Y^T <- bf16((1e-3 Y^T G^T)^2 + 0.25) on 64
// columns b a block.  The product's warpgroup (warps 0-3, when DOT)
// holds G^T as B: G itself read as K-major (row i of G along j), the
// [272][272] image (2Mt padded to 272, zero past 2Mt; 147 968 bytes),
// loaded once.  Y^T is A, in registers: 17 k16 slices, 68 registers.
// A step is two wgmma chains of 17 (N = 136 each: outputs i < 136, then
// i >= 136) into d0, d1 (136 registers); after wgmma.wait_group 0 each
// accumulator pair is squared, offset, rounded to bf16 and packed into
// the A register it already sits in the layout of, so yacc never passes
// through shared memory and no barrier falls inside a step.  Padded
// rows give 0.25, which meets the zero columns of the padded G.  The
// chain's [Mt, 64] tile (68 f32 a thread, rows 2jj + t / 64, column
// t % 64) runs in a second warpgroup (warps 4-7, when CHAIN) of the
// same block: mode both is whether the SM runs the FMA pipes while its
// tensor cores work asynchronously.  Mode chain holds no shared memory
// (its product warpgroup only waits); mode dot has no chain warpgroup.
// At the end the product's warpgroup leaves yacc[:Mt] in shared memory
// ([136][64] f32, over G's image) for the warpgroup that writes out.
// yacc starts at 0.3, as in the script, or at y0 [2Mt, Bt] when given
// (a start whose columns differ, so that a check can see the columns'
// mapping).
constexpr int kOvP = 2 * kMaxMt;                 // 272
constexpr int kOvKT = kOvP / 16;                 // 17 k16 slices
constexpr int kOvSBO = 128 * (kOvP / 8);         // bytes a block of 8 rows
constexpr size_t kOvSmem = (size_t)kOvP * kOvP * 2;

__device__ __forceinline__ uint32_t overlap_pack(float lo, float hi) {
  lo *= 1e-3f;
  hi *= 1e-3f;
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(fmaf(lo, lo, 0.25f), fmaf(hi, hi, 0.25f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <bool CHAIN, bool DOT>
__global__ void __launch_bounds__(256, 1)
    ub_overlap_kernel(const __nv_bfloat16* __restrict__ g_in,
                      const float* __restrict__ x,
                      const __nv_bfloat16* __restrict__ y0,
                      float* __restrict__ out, int Mt, int Bt, int reps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M2 = 2 * Mt;
  const int b0 = blockIdx.x * kTileCols;
  const int wg = CHAIN ? (int)(threadIdx.x >> 7) : 0;
  const int t = threadIdx.x & 127;
  float* ys = reinterpret_cast<float*>(smem_raw);   // [kMaxMt][64], at the end
  if (!DOT && wg == 0) {
    // mode chain: the product's warpgroup only waits, so that a block
    // holds an SM's registers as in mode both and the chain's tiles sit
    // one an SM there too (with blocks of 128 threads the scheduler
    // could put two tiles on one SM, and the chain's time at
    // Bt = 4096 changed from call to call)
    named_barrier(2, 256);
  } else if (DOT && wg == 0) {
    __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    for (int v = t; v < kOvP * (kOvP / 8); v += 128) {
      const int i = v / (kOvP / 8), jc = v % (kOvP / 8);
      __nv_bfloat16* dst =
          gs + ((i >> 3) * (kOvP / 8) + jc) * 64 + (i & 7) * 8;
      if (i < M2 && 8 * jc < M2)
        cp_async16(smem_addr(dst), g_in + (size_t)i * M2 + 8 * jc);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    const int warp = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    const int bl = 16 * warp + g;       // the thread's columns bl, bl + 8
    // a[kt][h]: row bl + 8 (h & 1), k = 16 kt + 2q + 8 (h >> 1), +1
    uint32_t a[kOvKT][4];
    const float start = __bfloat162float(__float2bfloat16(0.3f));
#pragma unroll
    for (int kt = 0; kt < kOvKT; ++kt) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 16 * kt + 2 * q + 8 * (h >> 1);
        const int b = b0 + bl + 8 * (h & 1);
        float lo = 0.f, hi = 0.f;
        if (j < M2) {
          if (y0 == nullptr) {
            lo = hi = start;
          } else if (b < Bt) {
            lo = __bfloat162float(y0[(size_t)j * Bt + b]);
            hi = __bfloat162float(y0[(size_t)(j + 1) * Bt + b]);
          }
        }
        a[kt][h] = bf16_pair(lo, hi);
      }
    }
    cp_async_wait<0>();
    fence_proxy_async();
    named_barrier(1, 128);
    float d0[68], d1[68];
#pragma unroll
    for (int i = 0; i < 68; ++i) d0[i] = d1[i] = 0.f;
    fence_acc(d0);
    fence_acc(d1);
    fence_a(a);
    const uint32_t base = smem_addr(gs);
    for (int r = 0; r < reps; ++r) {
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < kOvKT; ++kt)
        wgmma_m64n136k16(d0, a[kt], wgmma_desc(base + 256 * kt, 128, kOvSBO),
                         kt > 0);
#pragma unroll
      for (int kt = 0; kt < kOvKT; ++kt)
        wgmma_m64n136k16(
            d1, a[kt],
            wgmma_desc(base + (kWgN / 8) * kOvSBO + 256 * kt, 128, kOvSBO),
            kt > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(d0);
      fence_acc(d1);
#pragma unroll
      for (int kt = 0; kt < kOvKT; ++kt) {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int c = 2 * kt + (h >> 1);        // 8-column chunk of 272
          const int e = 4 * (c % 17) + 2 * (h & 1);
          a[kt][h] = c < 17 ? overlap_pack(d0[e], d0[e + 1])
                            : overlap_pack(d1[e], d1[e + 1]);
        }
      }
      fence_a(a);
    }
    // every warp's products have completed: G's image may be overwritten
    fence_proxy_async();
    named_barrier(1, 128);
#pragma unroll
    for (int kt = 0; kt < kOvKT; ++kt) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 16 * kt + 2 * q + 8 * (h >> 1);
        if (j < Mt) {
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(&a[kt][h]);
          const int col = bl + 8 * (h & 1);
          ys[j * kTileCols + col] = __low2float(v);
          ys[(j + 1) * kTileCols + col] = __high2float(v);
        }
      }
    }
    if (!CHAIN) {
      named_barrier(1, 128);
      const int c = t & 63, b = b0 + c;
      for (int jj = 0; jj < kMaxMt / 2; ++jj) {
        const int m = 2 * jj + (t >> 6);
        if (m < Mt && b < Bt)
          out[(size_t)m * Bt + b] =
              x[(size_t)m * Bt + b] + ys[m * kTileCols + c];
      }
    } else {
      named_barrier(2, 256);
    }
  } else if (CHAIN) {
    const int c = t & 63, b = b0 + c;
    float v[kMaxMt / 2];
#pragma unroll
    for (int jj = 0; jj < kMaxMt / 2; ++jj) {
      const int m = 2 * jj + (t >> 6);
      v[jj] = (m < Mt && b < Bt) ? x[(size_t)m * Bt + b] : 0.25f;
    }
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int jj = 0; jj < kMaxMt / 2; ++jj) {
#pragma unroll
        for (int k = 0; k < 12; ++k) v[jj] = fmaf(v[jj], v[jj], 0.25f);
        v[jj] *= 0.5f;
      }
    }
    named_barrier(2, 256);
    const float start = __bfloat162float(__float2bfloat16(0.3f));
#pragma unroll
    for (int jj = 0; jj < kMaxMt / 2; ++jj) {
      const int m = 2 * jj + (t >> 6);
      if (m < Mt && b < Bt) {
        const float y = DOT ? ys[m * kTileCols + c]
                        : y0 ? __bfloat162float(y0[(size_t)m * Bt + b])
                             : start;
        out[(size_t)m * Bt + b] = v[jj] + y;
      }
    }
  }
}

// ---------------------------------------------------------------------
// #10: sp [32, Bt] from 0.3; REPS x (rows 0-7 one by one, rows 8-15 as
// a block) v*v + 0.25; out = row 0
// ---------------------------------------------------------------------
// Each of the 16 x Bt stepped elements is a chain of REPS dependent
// FMAs of its own, one a thread (16 384 threads at Bt = 1024, about a
// warp a scheduler), so the call takes one chain's latency, REPS x the
// dependent FMA's (ubench.scalars_floor_ms), spread over the card.  The
// kernel starts the scratch itself: every thread writes its element of
// rows 0-15 after its chain and the 0.3 of rows 16-31 (which no step
// touches), so a call is one launch into a torch.empty scratch.  The
// start comes in as an argument, and each thread holds its own chain,
// so the compiler can neither fold the chains nor merge the 16 equal
// rows into one.
__global__ void ub_scalars_kernel(float* __restrict__ sp,
                                  float* __restrict__ out, int Bt, int reps,
                                  float start) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 16 * Bt) return;
  float v = start;
#pragma unroll 16
  for (int i = 0; i < reps; ++i) v = fmaf(v, v, 0.25f);
  sp[e] = v;                                     // row e / Bt, column e % Bt
  sp[16 * (size_t)Bt + e] = start;
  if (e < Bt) out[e] = v;
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

// t [Mt, n] bf16, idx [reps, Bt] int32 (an index outside [0, n) adds
// nothing), out [Mt, Bt] f32; Mt <= 136.  warps > 0: ub_gather_kernel
// with blocks of <warps> warps, img the bf16 scratch of the padded image
// ((n + 1) 8 ceil(Mt / 8) elements); warps 0: the wide instance (img
// unused).
extern "C" int bt_ub_onehot_gather(const void* t, const void* idx,
                                   void* out, void* img, int Mt, int n,
                                   int Bt, int reps, int warps,
                                   void* stream) {
  if (Mt <= 0 || Mt > kMaxMt || n <= 0 || Bt <= 0 || reps < 0 ||
      warps < 0 || warps > kGatherMaxWarps || (warps && img == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (warps == 0) {
    const size_t smem = (size_t)n * ((Mt + 1) & ~1) * 2;
    const int err = opt_in((const void*)ub_onehot_gather_wide_kernel, smem);
    if (err) return err;
    const int per = 8;
    ub_onehot_gather_wide_kernel<<<(Bt + per - 1) / per, 32 * per, smem,
                                   st>>>((const __nv_bfloat16*)t,
                                         (const int*)idx, (float*)out, Mt, n,
                                         Bt, reps);
    return (int)cudaGetLastError();
  }
  const int G = (Mt + 7) / 8, cw = 32 / min(G, 16);
  const int w8 = 8 * G, elems = (n + 1) * w8;
  const size_t smem = (size_t)elems * 2 +
                      (size_t)warps * 2 * cw * kGatherSlot * sizeof(int);
  const int blocks = ((Bt + cw - 1) / cw + warps - 1) / warps;
#define UB_GATHER(X)                                                         \
  {                                                                          \
    const int err = opt_in((const void*)ub_gather_kernel<X>, smem);         \
    if (err) return err;                                                     \
    ub_gather_pack_kernel<<<(elems + 255) / 256, 256, 0, st>>>(             \
        (const __nv_bfloat16*)t, (__nv_bfloat16*)img, Mt, n, w8);            \
    ub_gather_kernel<X><<<blocks, 32 * warps, smem, st>>>(                  \
        (const uint4*)img, (const int*)idx, (float*)out, Mt, n, Bt, reps,    \
        G);                                                                  \
  }
  if (G == 17)
    UB_GATHER(true)
  else
    UB_GATHER(false)
#undef UB_GATHER
  return (int)cudaGetLastError();
}

// The same function on the tensor cores; n <= 272, Bt a multiple of 16.
// img [136, 16 KT] bf16 scratch (KT = 2, 5, 17 for n <= 32, 80, 272);
// part [splits, Mt, Bt] f32 scratch when splits > 1 (each split's
// partial sum over its steps, then added in split order into out).
extern "C" int bt_ub_onehot_mma(const void* t, const void* idx, void* out,
                                void* img, void* part, int Mt, int n, int Bt,
                                int reps, int splits, void* stream) {
  if (Mt <= 0 || Mt > kMaxMt || n <= 0 || n > 16 * kMaxKT || Bt <= 0 ||
      Bt % 16 || reps < 0 || splits < 1 || img == nullptr ||
      (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int chunks = (reps + kIdxChunk - 1) / kIdxChunk;
  const int per = (chunks + splits - 1) / splits * kIdxChunk;
  const dim3 grid((Bt + kTileCols - 1) / kTileCols, splits);
  float* dst = splits > 1 ? (float*)part : (float*)out;
  const size_t idx_smem = 2 * kIdxChunk * kTileCols * sizeof(int);
#define UB_ONEHOT(KT)                                                        \
  {                                                                          \
    const size_t smem = (size_t)kWgN * 16 * KT * 2 + idx_smem;               \
    const int err = opt_in((const void*)ub_onehot_mma_kernel<KT>, smem);     \
    if (err) return err;                                                     \
    ub_onehot_pack_kernel<<<(kWgN * 16 * KT + 255) / 256, 256, 0, st>>>(     \
        (const __nv_bfloat16*)t, (__nv_bfloat16*)img, Mt, n, 16 * KT);       \
    ub_onehot_mma_kernel<KT><<<grid, 128, smem, st>>>(                       \
        (const __nv_bfloat16*)img, (const int*)idx, dst, Mt, Bt, reps, per); \
  }
  if (n <= 32)
    UB_ONEHOT(2)
  else if (n <= 80)
    UB_ONEHOT(5)
  else
    UB_ONEHOT(17)
#undef UB_ONEHOT
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const int count = Mt * Bt;
  ub_onehot_sum_kernel<<<(count + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)out, count, splits);
  return (int)cudaGetLastError();
}

// g [2Mt, 2Mt] bf16 (16-byte aligned), x and out [Mt, Bt] f32, y0
// [2Mt, Bt] bf16 or null (yacc from 0.3); mode 1 chain, 2 dot, 3 both;
// Mt a multiple of 8 up to 136, Bt of 32 (a last tile of 32 columns is
// masked).
extern "C" int bt_ub_overlap(const void* g, const void* x, const void* y0,
                             void* out, int Mt, int Bt, int mode, int reps,
                             void* stream) {
  if (Mt <= 0 || Mt % 8 || Mt > kMaxMt || Bt <= 0 || Bt % 32 || reps < 0 ||
      ((uintptr_t)g & 15))
    return cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int blocks = (Bt + kTileCols - 1) / kTileCols;
#define UB_OVERLAP(C, D)                                                     \
  {                                                                          \
    const size_t smem = D ? kOvSmem : 0;                                     \
    const int err = opt_in((const void*)ub_overlap_kernel<C, D>, smem);      \
    if (err) return err;                                                     \
    ub_overlap_kernel<C, D><<<blocks, C ? 256 : 128, smem, st>>>(            \
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

// sp [32, Bt] f32 scratch (the kernel writes all of it: rows 0-15
// stepped, rows 16-31 the 0.3 start), out [Bt] f32.
extern "C" int bt_ub_scalars(void* sp, void* out, int Bt, int reps,
                             void* stream) {
  if (Bt <= 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 128;
  ub_scalars_kernel<<<(16 * Bt + threads - 1) / threads, threads, 0, st>>>(
      (float*)sp, (float*)out, Bt, reps, 0.3f);
  return (int)cudaGetLastError();
}
