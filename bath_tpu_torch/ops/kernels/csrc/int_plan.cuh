// The plan of MSV's launches (msv_filter.cu) and of the SSV capture's
// (ssv_capture.cu), which reads MSV's table: the host's check of its
// class rows and the warps of a block of each kernel instance.

#pragma once

#include "plan.cuh"

// Warps of a block of the instance for lanes up to <pmax> and groups of
// up to <wmax> warps (ops/multimodel.py msv_block_warps).
__host__ __device__ constexpr int msv_warps(int pmax, int wmax) {
  return pmax <= 13 ? 8 : wmax <= 12 ? 12 : 32;
}

// Bytes of a segmented group's slot (plan.cuh) of a class of Mp padded
// lanes: MSV's SSV and MSV bytes of each lane (msv_item_seg), the SSV
// capture's one byte (ssv_item_seg).
__host__ __device__ constexpr size_t msv_seg_slot_bytes(int Mp) {
  return (size_t)Mp * sizeof(uint16_t);
}
__host__ __device__ constexpr size_t ssv_seg_slot_bytes(int Mp) {
  return (size_t)Mp;
}

// Checks a plan's classes (the host copy of the table) and gives the
// launch's largest P and W, whether a class reads its table from
// global memory, whether one is segmented (S > 1, its scratch given),
// and the dynamic shared memory.  nblk: the plan's blocks, 0 for MSV's
// one class striding over the items (which takes no segmented class),
// -1 for the SSV capture's one class (which does).  Returns 0, or a
// cudaError_t.
static int msv_check(const long long* plan, int ncls, int nblk, int warps,
                     int& pmax, int& wmax, bool& global, bool& seg,
                     size_t& smem) {
  const int cap = plan_smem_optin();
  if (ncls <= 0 || (nblk <= 0 && ncls != 1)) return cudaErrorInvalidValue;
  pmax = wmax = 0;
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
        (S > 1 && (W < 2 || G != 1 || c[9] == 0 || nblk == 0 || c[7])))
      return cudaErrorInvalidValue;
    const size_t need = (c[7] ? (size_t)Kp * Mp * sizeof(uint16_t) : 0) +
                        (size_t)G * 16 * W + (S > 1 ? 32 : 0);
    smem = need > smem ? need : smem;
    pmax = P > pmax ? P : pmax;
    wmax = W > wmax ? W : wmax;
    global = global || c[7] == 0;
    seg = seg || S > 1;
  }
  // a segmented group's instances take blocks of its 16 warps
  if (warps > (seg ? 16 : msv_warps(pmax, wmax))) return cudaErrorInvalidValue;
  return smem <= (size_t)cap ? 0 : cudaErrorInvalidValue;
}
