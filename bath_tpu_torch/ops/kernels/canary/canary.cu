// Known faults for the sanitizer tier (bath_tpu_torch/sanitize.py): one
// kernel for each check of compute-sanitizer, each with the fault its
// tool must report.  A clean run of the port's kernels under a tool
// counts only after the tool has reported its canary in the same run.
// Built into a library of its own beside the kernels' (never linked
// into it, never reachable from a search), with the same flags, and
// named and templated like them (an anonymous namespace, a template
// parameter), so that the tool's kernel filter is shown to match names
// of their form.
//   0 memcheck   a launch that writes one int past its buffer
//   1 racecheck  two warps write and read one shared array unsynced
//   2 initcheck  a launch that reads device memory nothing wrote
//   3 synccheck  __syncthreads() reached by half of a warp

#include <cuda_runtime.h>

namespace {

template <int PAST>
__global__ void canary_write_past_kernel(int* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n + PAST) out[i] = i;
}

template <int WARPS>
__global__ void canary_race_kernel(int* out) {
  __shared__ int s[32 * WARPS];
  s[threadIdx.x] = threadIdx.x;
  out[threadIdx.x] = s[(threadIdx.x + 32) % (32 * WARPS)];
}

template <int N>
__global__ void canary_uninit_kernel(const int* in, int* out) {
  out[threadIdx.x] = in[threadIdx.x % N] + 1;
}

template <int HALF>
__global__ void canary_divergent_sync_kernel(int* out) {
  if (threadIdx.x < HALF) {
    __syncthreads();
    out[threadIdx.x] = 1;
  }
}

}  // namespace

// Runs canary <which> on the current device and returns the CUDA error
// of its launch and synchronisation (0 where the tool let it pass).
extern "C" int bt_canary(int which) {
  const int n = 1000;
  int *out = nullptr, *in = nullptr;
  if (cudaMalloc(&out, n * sizeof(int)) != cudaSuccess) return -1;
  if (cudaMalloc(&in, n * sizeof(int)) != cudaSuccess) return -1;
  switch (which) {
    case 0:
      canary_write_past_kernel<1><<<(n + 128) / 128, 128>>>(out, n);
      break;
    case 1:
      canary_race_kernel<2><<<1, 64>>>(out);
      break;
    case 2:
      canary_uninit_kernel<64><<<1, 64>>>(in, out);
      break;
    case 3:
      canary_divergent_sync_kernel<16><<<1, 32>>>(out);
      break;
    default:
      return -2;
  }
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  cudaFree(in);
  cudaFree(out);
  return (int)err;
}
