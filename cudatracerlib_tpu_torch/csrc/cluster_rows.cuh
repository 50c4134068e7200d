// Row sources that stage a table of fat rows on chip for a whole launch or
// segment, shared by K2's split variant (traversal_tt.cu: SplitStage),
// P1's shared and cluster modes (microbench.cu: ClusterStage) and the
// rejected designs of csrc/schedule_probe.cu (K3's staged slabs, K2's
// cluster design):
// - ClusterStage<n>: the table spread over the dynamic shared memory of a
//   cluster of n blocks, row i in block rank i % n at local row i / n,
//   read through the cluster's distributed shared memory;
// - SplitStage: one block, no cluster, holds rows 0-452 in its shared
//   memory and reads the rest from device memory.
// A source gives a row's base pointer (row) and its swizzle, as
// bvh8_traverse.cuh's GlobalRows and SharedRows do, so the traversal's
// step runs on it unchanged; stage copies the block's share in, and table
// says which table pointer the step gets. Also here: the barrier of a
// cluster of kRanks blocks and the launch of a persistent grid of
// clusters, sized from cudaOccupancyMaxActiveClusters.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "bvh8_traverse.cuh"

// The start of a block's dynamic shared memory, where a staged table's
// share lives.
extern __shared__ float4 staged_rows[];

namespace ctl {

// rows of a split design's share: 453 x 512 bytes and a few words of the
// kernel's fill the 227 KB a block may hold
constexpr int kSplitRows = 453;

// The table spread over the dynamic shared memory of a cluster of kRanks
// blocks (`table` is not read): row i lives in block rank i % kRanks at
// local row i / kRanks, swizzled by the local row. With kRanks a
// compile-time power of two the rank and the local row are a mask and a
// shift of the row index, so the source holds no pointer and no runtime
// state; a row in another block is read through that block's shared
// window (distributed shared memory, a generic LD).
template <int kRanks>
struct ClusterStage {
  static_assert((kRanks & (kRanks - 1)) == 0 && kRanks >= 1 && kRanks <= 8,
                "a cluster of 1, 2, 4 or 8 blocks");
  static __device__ __forceinline__ const float4* row(const float4*, int i) {
    const float4* local = staged_rows + (size_t)(i / kRanks) * 32;
    if constexpr (kRanks == 1) {
      return local;
    } else {
      return cooperative_groups::this_cluster().map_shared_rank(
          const_cast<float4*>(local), (unsigned)(i % kRanks));
    }
  }
  static __device__ __forceinline__ int swizzle(int row) {
    return (row / kRanks) & 31;
  }
  // this block's rows of the table: rows rank, rank + kRanks, ...
  static __device__ __forceinline__ void stage(const float4* table, int rows,
                                               unsigned rank) {
    stage_rows(staged_rows, table + (size_t)rank * 32,
               (rows - (int)rank + kRanks - 1) / kRanks, kRanks);
  }
  static __device__ __forceinline__ const float4* table(const float4*) {
    return nullptr;
  }
  // the dynamic shared bytes of one block for a table of `rows` rows
  static size_t bytes(int rows) {
    return (size_t)((rows + kRanks - 1) / kRanks) * 512;
  }
};

// Rows below kSplitRows in the block's shared memory, swizzled as
// SharedRows; the rest read from the table in device memory (`table`).
struct SplitStage {
  static __device__ __forceinline__ const float4* row(const float4* table,
                                                      int i) {
    return i < kSplitRows ? staged_rows + i * 32 : table + (size_t)i * 32;
  }
  static __device__ __forceinline__ int swizzle(int row) {
    return row < kSplitRows ? row & 31 : 0;
  }
  static __device__ __forceinline__ void stage(const float4* table, int rows,
                                               unsigned) {
    stage_rows(staged_rows, table, rows < kSplitRows ? rows : kSplitRows);
  }
  static __device__ __forceinline__ const float4* table(const float4* t) {
    return t;
  }
  static size_t bytes(int rows) {
    return (size_t)(rows < kSplitRows ? rows : kSplitRows) * 512;
  }
};

template <int kRanks>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kRanks == 1) {
    __syncthreads();
  } else {
    cooperative_groups::this_cluster().sync();
  }
}

template <int kRanks>
__device__ __forceinline__ unsigned cluster_rank() {
  if constexpr (kRanks == 1) {
    return 0u;
  } else {
    return cooperative_groups::this_cluster().block_rank();
  }
}

// What a cluster launch of one kernel needs from the runtime, kept for each
// device so that a launch asks the runtime nothing: the dynamic shared
// bytes it is opted in to, and how many of its clusters fit on the card at
// once with that many bytes.
struct ClusterOptIn {
  size_t bytes[kMaxDevices] = {};
  int clusters[kMaxDevices] = {};
};

// Launches `kernel` on `stream` as a persistent grid of clusters of
// `ranks` blocks of `threads` threads with `bytes` of dynamic shared
// memory each: as many clusters as fit on the card at once, no more than
// `need` (at least one). Returns the first CUDA error; a refused opt-in or
// launch is returned and cleared from the runtime's last error, and a
// configuration of which no cluster can be resident at once is refused
// (cudaErrorInvalidConfiguration): the caller raises, nothing falls back.
template <class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), ClusterOptIn& opt, int ranks,
                    int threads, size_t bytes, int need, cudaStream_t stream,
                    Args... args) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (opt.clusters[dev] == 0 || opt.bytes[dev] < bytes) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    int clusters = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    }
    if (err == cudaSuccess && clusters <= 0) {
      err = cudaErrorInvalidConfiguration;
    }
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    opt.bytes[dev] = bytes;
    opt.clusters[dev] = clusters;
  }
  const int clusters = opt.clusters[dev] < need ? opt.clusters[dev]
                                                : (need > 0 ? need : 1);
  cfg.gridDim = dim3(clusters * ranks);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace ctl
