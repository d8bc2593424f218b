// The launch plan of the kernels that take every padded width of a call
// in one launch (ops/multimodel.py _plan: fs3_plan, domdec_plan,
// vit_plan): one int64 table that the host builds and uploads in one
// copy.
//   classes, PLAN_CLS words each: the addresses of the class's stacked
//     tables, P, W, Mp, G (the groups a block of the class holds), two
//     words of the kernel's own, the segments S a group walks each row
//     in (1: the row at once; int_common.cuh, dp_common.cuh) and the
//     address of a segmented class's scratch (seg_take below);
//   blocks, PLAN_BLK words each: class, model (its index in the class's
//     stacks), M, first item, item count;
//   items: item rows (b, or passes * b + pass).
// Each block runs the P of its class, its groups of W warps side by
// side, one item a group, all of one model.  The host orders the blocks
// heaviest first, so the longest chains start first.

#pragma once

#include <cuda_runtime.h>

constexpr int PLAN_CLS = 10;        // int64 words of a class row
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

// A segmented class's scratch (class row word 9): the count n of its
// slots, a flag a slot (0: free), and from seg_header_bytes(n) on the
// slots, each of the bytes its kernel's segments keep (the kernels'
// *_seg_slot_bytes).  A segmented block takes a free slot when it
// starts (seg_take) and frees it when it ends (seg_free), so that the
// scratch needs a slot for each segmented block the card holds at once,
// not one an item; with fewer, a block waits for one.  The host sizes
// the scratch with the kernels' bt_*_seg_bytes and writes the header.
__host__ __device__ constexpr size_t seg_header_bytes(int n) {
  return ((size_t)4 * (n + 1) + 255) / 256 * 256;
}

static inline long long seg_scratch_bytes(size_t slot_bytes, int n) {
  return n < 1 ? -1 : (long long)(seg_header_bytes(n) + slot_bytes * n);
}

// Every thread of a segmented block calls it: thread 0 takes a free slot
// of the class <c>'s scratch and passes its index <id> through the
// shared word <word>, which no thread touches until this returns.  Gives
// the slot's address.
__device__ __forceinline__ char* seg_take(const long long* c,
                                          size_t slot_bytes, int* word,
                                          int& id) {
  int* head = reinterpret_cast<int*>(c[9]);
  const int n = head[0];
  if (threadIdx.x == 0) {
    const int start = blockIdx.x % n;
    int i = start;
    while (atomicCAS(head + 1 + i, 0, 1) != 0) {
      i = i + 1 == n ? 0 : i + 1;
      if (i == start) __nanosleep(1000);
    }
    __threadfence();
    *word = i;
  }
  __syncthreads();
  id = *word;
  __syncthreads();
  return reinterpret_cast<char*>(head) + seg_header_bytes(n) +
         (size_t)id * slot_bytes;
}

// Every thread of the block calls it once it is done with slot <id>.
__device__ __forceinline__ void seg_free(const long long* c, int id) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicExch(reinterpret_cast<int*>(c[9]) + 1 + id, 0);
  }
}
