// Microbenchmarks of the traversal kernels' building blocks for NVIDIA
// Hopper (sm_90a): P1, P2 and P3. They are measurement kernels, not on the
// render path; utils/microbench.py wraps them and holds each against its
// plain PyTorch version.
//
// Replace the TPU microbenchmarks and Mosaic probes
//   P1 tools/microbench_r2.py::kern_take, ::kern_onehot (dependent row
//      gathers from a VMEM table, by take or a one-hot matmul);
//   P2 tools/microbench_r2c.py::trivial_loop, ::lane_gather,
//      ::onehot_nofeedback (loop overhead; independent row gathers);
//   P3 tools/probe_mosaic_pool.py (the building blocks of the pool kernel's
//      queue: lane gathers, a lane prefix sum, a one-hot scatter).
// On Hopper they ask what bounds K1-K4 and what no profiler on the card's
// machine can give:
//   P1 chase_rows: each chain runs S dependent steps; each step reads the
//      first W float4 of a 512-byte row (W = 32, the whole row, or 14, what
//      a traversal's node step reads: bvh8_traverse.cuh's boxes and links)
//      and derives the next row from them. It measures the latency of a
//      dependent row fetch in the ways the traversal kernels read rows
//      (ctl_chase_rows's modes):
//      - thread: one thread a chain reads the row as W float4 through
//        L1/L2 (K1's per-thread design, K2's per-thread design);
//      - shared: the same from the block's copy of the table in shared
//        memory (K1's and K2's shared variants; it stands in for the
//        one-hot matmul: both ask what a row costs from on-chip memory);
//      - group: G lanes a chain (16: K1's group design), lane g reading
//        float4 g, g + G, ... below W coalesced, the xor reduced with
//        shuffles;
//      - cluster: the table over a cluster of n blocks in ClusterStage's
//        layout (cluster_rows.cuh), one thread a chain reading through
//        distributed shared memory (K2's cluster design);
//      - bulk: one lane a chain copies the row's W float4 into its own
//        512 bytes of shared memory with cp.async.bulk and an mbarrier,
//        then reads them there (TMA's dependent fetch).
//      A chain takes `lanes` threads (1, G, or 32: one chain a warp, the
//      latency alone), the others idle; staged rows are swizzled (float4
//      k of local row i at k ^ (i & 31)) so that lanes reading different
//      rows spread over the banks.
//   P2 gather_rows: independent random row gathers, bound by L2 or device
//      memory bandwidth; thread-per-row (K1's layout) or warp-per-row (32
//      lanes x 16 B, coalesced: the counterpart of lane_gather).
//      loop_only: an empty dependent float loop, bound by instruction
//      latency (trivial_loop's question: what does a step cost by itself).
//   P3 queue_fetch: persistent warps drain a queue of n items through
//      exactly K4's fetch (warp_queue.cuh) with no work per item; each item
//      adds one to its count, so a count other than 1 is a queue fault.
//      Bound by the atomic on the one counter.
// A row's value is the xor of its first 4W 32-bit words; after step s a chain goes to
// row ((that xor + s * 0x9E3779B9) mod 2^32) mod the row count: the row's
// words decide it (the load cannot be skipped), and the step term keeps a
// chain from closing into a short cycle of cached rows. Launches go on the
// caller's stream and allocate nothing.

#include "cluster_rows.cuh"
#include "warp_queue.cuh"

namespace {

using namespace ctl;

constexpr int kThreadsMb = 128;

__device__ __forceinline__ unsigned xor4(float4 q) {
  return __float_as_uint(q.x) ^ __float_as_uint(q.y) ^ __float_as_uint(q.z) ^
         __float_as_uint(q.w);
}

// The xor of a row's first kWords float4.
template <int kWords = 32>
__device__ __forceinline__ unsigned row_xor(const float4* __restrict__ row) {
  unsigned h = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) h ^= xor4(row[k]);
  return h;
}

__device__ __forceinline__ int next_row(unsigned h, int s, int n_rows) {
  return (int)((h + (unsigned)s * 0x9E3779B9u) % (unsigned)n_rows);
}

// P1's modes, the C entry's codes
constexpr int kChaseThread = 0, kChaseShared = 1, kChaseGroup = 2;
constexpr int kChaseCluster = 3, kChaseBulk = 4;

// The chain thread t runs, or -1: chains take `lanes` threads each, the
// first of which runs it (a group mode's G lanes run it together).
__device__ __forceinline__ int chain_of(int t, int lanes, int n_chains) {
  const int c = t / lanes;
  return (t % lanes == 0 && c < n_chains) ? c : -1;
}

template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_kernel(const float4* __restrict__ table, int n_rows,
                  const int* __restrict__ idx0, int n_chains, int n_steps,
                  int lanes, int* __restrict__ out) {
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    idx = next_row(row_xor<kWords>(table + (size_t)idx * 32), s, n_rows);
  }
  out[c] = idx;
}

// One chain from a table staged on chip by the row source Rows (shared
// memory, or a cluster's).
template <class Rows, int kWords>
__device__ __forceinline__ int chase_staged(int idx, int n_steps,
                                            int n_rows) {
  for (int s = 0; s < n_steps; ++s) {
    const float4* row = Rows::row(nullptr, idx);
    const int sw = Rows::swizzle(idx);
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) h ^= xor4(row[k ^ sw]);
    idx = next_row(h, s, n_rows);
  }
  return idx;
}

template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_shared_kernel(const float4* __restrict__ table, int n_rows,
                         const int* __restrict__ idx0, int n_chains,
                         int n_steps, int lanes, int* __restrict__ out) {
  ClusterStage<1>::stage(table, n_rows, 0u);
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  out[c] = chase_staged<ClusterStage<1>, kWords>(idx0[c], n_steps, n_rows);
}

// G lanes a chain: lane g of the group reads float4 g, g + G, ... of the
// row's first kWords (each G float4 one coalesced access), and shuffles
// within the group xor the parts. Whole warps run the loop (the shuffles take every lane):
// a lane of no chain runs the last chain's and writes nothing.
template <int G, int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_group_kernel(const float4* __restrict__ table, int n_rows,
                        const int* __restrict__ idx0, int n_chains,
                        int n_steps, int lanes, int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t % lanes;
  const int c = min(t / lanes, n_chains - 1);
  const bool writes = g == 0 && t / lanes < n_chains;
  const int k0 = g % G;  // lanes past G repeat the group's loads
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    const float4* row = table + (size_t)idx * 32;
    unsigned h = 0u;
#pragma unroll
    for (int j = 0; j < 32 / G; ++j) {
      if (k0 + j * G < kWords) h ^= xor4(row[k0 + j * G]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      h ^= __shfl_xor_sync(kFullMask, h, off);
    }
    idx = next_row(h, s, n_rows);
  }
  if (writes) out[c] = idx;
}

// The table over a cluster of kRanks blocks (ClusterStage): every block
// stages its share, the cluster meets, the threads run their chains (a
// grid-stride loop, so that any grid the card can hold at once runs them
// all), and the cluster meets again before any block leaves.
template <int kRanks, int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_cluster_kernel(const float4* __restrict__ table, int n_rows,
                          const int* __restrict__ idx0, int n_chains,
                          int n_steps, int lanes, int* __restrict__ out) {
  ClusterStage<kRanks>::stage(table, n_rows, cluster_rank<kRanks>());
  cluster_sync<kRanks>();
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n_chains * lanes;
       t += gridDim.x * blockDim.x) {
    const int c = chain_of(t, lanes, n_chains);
    if (c >= 0) {
      out[c] = chase_staged<ClusterStage<kRanks>, kWords>(idx0[c], n_steps,
                                                           n_rows);
    }
  }
  cluster_sync<kRanks>();
}

// One lane a chain: each step copies the row's first kWords float4 into
// the thread's own 512 bytes of shared memory with one cp.async.bulk (the
// copy engine, through L2), whose completion the thread's mbarrier counts
// in bytes, waits for the barrier's phase, and reads them there (swizzled
// by the lane: the whole row's float4 k at k ^ lane, a node step's 14
// rotated by the lane, so that the lanes spread over the banks). The next
// copy's address depends on every word read, so the reads are done before
// the copy that overwrites them is issued.
template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_bulk_kernel(const float4* __restrict__ table, int n_rows,
                       const int* __restrict__ idx0, int n_chains,
                       int n_steps, int lanes, int* __restrict__ out) {
  extern __shared__ float4 bulk_rows[];
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  float4* buf = bulk_rows + threadIdx.x * 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_rows + blockDim.x * 32);
  const unsigned bar = (unsigned)__cvta_generic_to_shared(bars + threadIdx.x);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  constexpr unsigned kBytes = kWords * 16;
  const int sw = threadIdx.x & 31;
  unsigned phase = 0u;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kBytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dst),
        "l"(table + (size_t)idx * 32), "r"(kBytes), "r"(bar)
        : "memory");
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "LAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\n"
        "bra LAB_WAIT;\n"
        "DONE:\n"
        "}\n" ::"r"(bar),
        "r"(phase)
        : "memory");
    phase ^= 1u;
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      h ^= xor4(buf[kWords == 32 ? (k ^ sw) : (k + sw) % kWords]);
    }
    idx = next_row(h, s, n_rows);
  }
  out[c] = idx;
}

__global__ void __launch_bounds__(kThreadsMb)
gather_rows_thread_kernel(const float4* __restrict__ table,
                          const int* __restrict__ idx, int n,
                          int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int)row_xor(table + (size_t)idx[i] * 32);
}

__global__ void __launch_bounds__(kThreadsMb)
gather_rows_warp_kernel(const float4* __restrict__ table,
                        const int* __restrict__ idx, int n,
                        int* __restrict__ out) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // warp-uniform: a warp owns one row
  unsigned h = xor4(table[(size_t)idx[i] * 32 + lane]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) h ^= __shfl_xor_sync(kFullMask, h, off);
  if (lane == 0) out[i] = (int)h;
}

__global__ void __launch_bounds__(kThreadsMb)
loop_only_kernel(const float* __restrict__ x0, int n, int n_steps,
                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = x0[i];
  for (int s = 0; s < n_steps; ++s) x = x * 1.000001f + 1.0f;
  out[i] = x;
}

__global__ void __launch_bounds__(kThreadsMb)
queue_fetch_kernel(int* counter, int n, int* __restrict__ counts) {
  bool drained = false;
  while (!drained) {
    const int id = warp_fetch(counter, true, n, drained);
    if (id >= 0) atomicAdd(counts + id, 1);
  }
}

int blocks_for(int n) { return (n + kThreadsMb - 1) / kThreadsMb; }

// Opts `kernel` in to `bytes` of dynamic shared memory when it needs more
// than the default 48 KB; returns the CUDA error (cleared).
template <class Kernel>
int opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <int kRanks, int kWords>
int launch_chase_cluster(const float4* table, int n_rows, const int* idx0,
                         int n_chains, int n_steps, int lanes, int threads,
                         int* out, cudaStream_t s) {
  static ClusterOptIn opt;
  const int blocks = (n_chains * lanes + threads - 1) / threads;
  return launch_clusters(chase_rows_cluster_kernel<kRanks, kWords>, opt,
                         kRanks, threads, ClusterStage<kRanks>::bytes(n_rows),
                         (blocks + kRanks - 1) / kRanks, s, table, n_rows,
                         idx0, n_chains, n_steps, lanes, out);
}

// P1's launch in `mode` reading kWords float4 a step, the arguments
// checked by ctl_chase_rows (`staged`: the shared or cluster mode's bytes
// of a block's share).
template <int kWords>
int launch_chase(const float4* t4, int n_rows, const int* idx0, int n_chains,
                 int n_steps, int mode, int param, int lanes, int threads,
                 size_t staged, int* out, cudaStream_t s) {
  const int blocks = (n_chains * lanes + threads - 1) / threads;
  int err = 0;
  switch (mode) {
    case kChaseThread:
      chase_rows_kernel<kWords><<<blocks, threads, 0, s>>>(
          t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      break;
    case kChaseShared:
      err = opt_in(chase_rows_shared_kernel<kWords>, staged);
      if (err == 0) {
        chase_rows_shared_kernel<kWords><<<blocks, threads, staged, s>>>(
            t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      }
      break;
    case kChaseGroup: {
      auto kernel = param == 8    ? chase_rows_group_kernel<8, kWords>
                    : param == 16 ? chase_rows_group_kernel<16, kWords>
                                  : chase_rows_group_kernel<32, kWords>;
      kernel<<<blocks, threads, 0, s>>>(t4, n_rows, idx0, n_chains, n_steps,
                                        lanes, out);
      break;
    }
    case kChaseCluster: {
      auto launch = param == 1   ? launch_chase_cluster<1, kWords>
                    : param == 2 ? launch_chase_cluster<2, kWords>
                    : param == 4 ? launch_chase_cluster<4, kWords>
                                 : launch_chase_cluster<8, kWords>;
      return launch(t4, n_rows, idx0, n_chains, n_steps, lanes, threads, out,
                    s);
    }
    default: {
      const size_t bytes = (size_t)threads * (512 + 8);
      err = opt_in(chase_rows_bulk_kernel<kWords>, bytes);
      if (err == 0) {
        chase_rows_bulk_kernel<kWords><<<blocks, threads, bytes, s>>>(
            t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      }
    }
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// P1 in `mode` (0 thread, 1 shared, 2 group, 3 cluster, 4 bulk) with
// `param` (group: G = 8, 16 or 32 lanes a chain; cluster: n = 1, 2, 4 or
// 8 blocks; else unused), `lanes` threads a chain (a power of two up to
// 32, at least G), blocks of `threads` threads (a multiple of 32 up to
// kThreadsMb) and `words` float4 read a step (14 or 32). Returns a CUDA
// error code, or -1 for another mode, param, shape or words, or a table
// whose rows (shared: all, cluster: a block's share) do not fit a block's
// shared memory.
extern "C" int ctl_chase_rows(const float* table, int n_rows, const int* idx0,
                              int n_chains, int n_steps, int mode, int param,
                              int lanes, int threads, int words, int* out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (mode < kChaseThread || mode > kChaseBulk || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || threads < 32 || threads > kThreadsMb ||
      threads % 32 != 0 || (words != 14 && words != 32)) {
    return -1;
  }
  if (mode == kChaseGroup && param != 8 && param != 16 && param != 32) {
    return -1;
  }
  if (mode == kChaseGroup && lanes < param) return -1;
  if (mode == kChaseCluster && param != 1 && param != 2 && param != 4 &&
      param != 8) {
    return -1;
  }
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int ranks = mode == kChaseCluster ? param : 1;
  const size_t staged = (size_t)((n_rows + ranks - 1) / ranks) * 512;
  if ((mode == kChaseShared || mode == kChaseCluster) &&
      staged > (size_t)limit) {
    return -1;
  }
  if (n_chains <= 0) return (int)cudaGetLastError();
  auto launch = words == 14 ? launch_chase<14> : launch_chase<32>;
  return launch(t4, n_rows, idx0, n_chains, n_steps, mode, param, lanes,
                threads, staged, out, s);
}

// P2. warp != 0: one warp per row.
extern "C" int ctl_gather_rows(const float* table, const int* idx, int n,
                               int warp, int* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (n > 0) {
    if (warp) {
      gather_rows_warp_kernel<<<blocks_for(n * 32), kThreadsMb, 0, s>>>(
          t4, idx, n, out);
    } else {
      gather_rows_thread_kernel<<<blocks_for(n), kThreadsMb, 0, s>>>(
          t4, idx, n, out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int ctl_loop_only(const float* x0, int n, int n_steps, float* out,
                             void* stream) {
  if (n > 0) {
    loop_only_kernel<<<blocks_for(n), kThreadsMb, 0, (cudaStream_t)stream>>>(
        x0, n, n_steps, out);
  }
  return (int)cudaGetLastError();
}

// P3. counts must hold n zeros; the queue counter is zeroed here.
extern "C" int ctl_queue_fetch(int n, int* counter, int* counts,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    cudaMemsetAsync(counter, 0, sizeof(int), s);
    const int blocks = persistent_blocks(queue_fetch_kernel, kThreadsMb, n);
    queue_fetch_kernel<<<blocks, kThreadsMb, 0, s>>>(counter, n, counts);
  }
  return (int)cudaGetLastError();
}
