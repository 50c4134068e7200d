// A global work queue drained by whole warps, shared by the pool traversal
// kernel K4 (traversal_pool.cu) and its microbenchmark P3 (microbench.cu).
//
// It is the Hopper counterpart of the TPU pool kernel's lane prefix sum
// (cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel_pool): the lanes
// that need an item vote with __ballot_sync, one lane claims that many items
// with a single atomicAdd on the queue counter and broadcasts the base with
// __shfl_sync, and each asking lane takes base + its rank among the askers.
//
// Every lane of the warp must call warp_fetch together (the intrinsics take
// the full mask): the caller's loop has to be warp-uniform. `drained` is
// warp-uniform too; once set, the warp claims nothing more.
#pragma once

#include <cuda_runtime.h>

namespace ctl {

constexpr unsigned kFullMask = 0xffffffffu;

// Returns the item this lane takes, or -1 (it did not ask, or the queue of
// `n` items ran out). Sets `drained` once the queue has no item left.
__device__ __forceinline__ int warp_fetch(int* counter, bool need, int n,
                                          bool& drained) {
  const unsigned mask = __ballot_sync(kFullMask, need);
  if (mask == 0u || drained) return -1;
  const int lane = threadIdx.x & 31;
  const int count = __popc(mask);
  int base = 0;
  if (lane == 0) base = atomicAdd(counter, count);
  base = __shfl_sync(kFullMask, base, 0);
  if (base + count >= n) drained = true;
  if (!need) return -1;
  const int id = base + __popc(mask & ((1u << lane) - 1u));
  return id < n ? id : -1;
}

// Blocks of `threads` threads that fill every SM of the current device once
// (persistent threads), but no more blocks than `n_items` needs.
template <class Kernel>
int persistent_blocks(Kernel kernel, int threads, int n_items) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const int need = (n_items + threads - 1) / threads;
  const int blocks = per_sm * sms;
  return blocks < need ? (blocks > 0 ? blocks : 1) : need;
}

}  // namespace ctl
