// The launch plan of the kernels that take every padded width of a call
// in one launch (ops/multimodel.py _plan: fs3_plan, domdec_plan,
// vit_plan): one int64 table that the host builds and uploads in one
// copy.
//   classes, PLAN_CLS words each: the addresses of the class's stacked
//     tables, P, W, Mp, G (the groups a block of the class holds) and
//     two words of the kernel's own;
//   blocks, PLAN_BLK words each: class, model (its index in the class's
//     stacks), M, first item, item count;
//   items: item rows (b, or passes * b + pass).
// Each block runs the P of its class, its groups of W warps side by
// side, one item a group, all of one model.  The host orders the blocks
// heaviest first, so the longest chains start first.

#pragma once

#include <cuda_runtime.h>

constexpr int PLAN_CLS = 8;         // int64 words of a class row
constexpr int PLAN_BLK = 5;         // of a block row

// What the block's row of the plan says.
struct PlanBlock {
  const long long* cls;   // its class row
  int model, M, first, count;
  int gi;                 // this thread's group in the block
  int item;               // the group's item, or -1
};

// Every thread of the block may call it; <W> is read from the class row.
__device__ __forceinline__ PlanBlock plan_block(
    const long long* __restrict__ plan, int ncls, int nblk) {
  const long long* bk =
      plan + PLAN_CLS * ncls + PLAN_BLK * (long long)blockIdx.x;
  PlanBlock p;
  p.cls = plan + PLAN_CLS * bk[0];
  p.model = (int)bk[1];
  p.M = (int)bk[2];
  p.first = (int)bk[3];
  p.count = (int)bk[4];
  const int W = (int)p.cls[3], G = (int)p.cls[5];
  p.gi = (threadIdx.x >> 5) / W;
  p.item = p.gi < G && p.gi < p.count
               ? (int)plan[PLAN_CLS * ncls + PLAN_BLK * nblk + p.first + p.gi]
               : -1;
  return p;
}

// The dynamic shared memory a block may take on the current device,
// asked once a device (the plan checks run at every launch).
static inline int plan_smem_optin() {
  static int cap[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& c = cap[dev & 63];
  if (!c)
    cudaDeviceGetAttribute(&c, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return c;
}
