// A global work queue drained by whole warps, shared by the pool traversal
// kernel K4 (traversal_pool.cu) and its microbenchmark P3 (microbench.cu),
// and the work area of the launches that hand out rays inside the launch
// (K4 and K1's group design).
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

// K4's claim (traversal_pool.cu), which P3's threshold form
// (microbench.cu) times: a warp claims only when at least kFetchIdle of its
// lanes are idle, and a lane fetches up to kFetchRounds times in one
// iteration while it draws dead rays.
constexpr int kFetchIdle = 8;
constexpr int kFetchRounds = 4;

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

// The work area of a launch that hands out its rays inside the launch
// (K1's group design, traversal8.cu; K4, traversal_pool.cu), int32, kept by
// the caller from launch to launch on one stream: two sets of counters,
// kSet words apart, each counter on its own 128-byte line, then (the group
// design) one queue slot per ray from word kWork. Launches on the stream
// take the sets in turn: a launch counts in one set, which the caller gives
// it zeroed, and zeroes the other for the next launch (zero_set), so no
// launch needs a memset. The counters: the rays claimed from the input;
// the live rays (the group design's live queue's tail); the group design's
// live queue's head; the rays classified (written dead or taken live); and
// two int64, the lane slots the launch's warps issued (32 a warp iteration
// of the traversal loop) and the lane steps run in them (equal to the sum
// of the rays' steps).
constexpr int kInput = 0, kTail = 32, kHead = 64, kClassified = 96;
constexpr int kUtilSlots = 128, kUtilActive = 160;
constexpr int kSet = 192, kWork = 384;

// Zeroes the other counter set `next` for the launch after this one (block
// 0 of the grid does it).
__device__ __forceinline__ void zero_set(int* next) {
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < kSet; k += blockDim.x) next[k] = 0;
  }
}

// Adds a warp's counts to its launch's counter set `work`, from lane 0:
// `live` and `classified` are this lane's, summed over the warp here;
// `slots` and `active` are warp-uniform. Every lane of the warp calls it.
__device__ __forceinline__ void add_counts(int* work, int live,
                                           int classified, long long slots,
                                           long long active) {
  live = __reduce_add_sync(kFullMask, live);
  classified = __reduce_add_sync(kFullMask, classified);
  if ((threadIdx.x & 31) != 0) return;
  if (live != 0) atomicAdd(work + kTail, live);
  if (classified != 0) atomicAdd(work + kClassified, classified);
  if (slots != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(work + kUtilSlots),
              (unsigned long long)slots);
    atomicAdd(reinterpret_cast<unsigned long long*>(work + kUtilActive),
              (unsigned long long)active);
  }
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
