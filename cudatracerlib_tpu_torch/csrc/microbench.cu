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
//   P1 chase_rows: one thread per chain runs S dependent steps; each step
//      reads a whole 512-byte row as 32 float4 (as K1 does) and derives the
//      next row from it. Bound by the latency of a dependent row fetch, from
//      device memory through L1/L2, or from shared memory where the table
//      fits the 227 KB a block may use (the shared variant stands in for
//      the one-hot matmul: both ask what a row costs from on-chip memory).
//      Shared rows are swizzled (float4 k of row i at k ^ (i & 31)), so the
//      lanes of a warp reading different rows spread over the banks.
//   P2 gather_rows: independent random row gathers, bound by L2 or device
//      memory bandwidth; thread-per-row (K1's layout) or warp-per-row (32
//      lanes x 16 B, coalesced: the counterpart of lane_gather).
//      loop_only: an empty dependent float loop, bound by instruction
//      latency (trivial_loop's question: what does a step cost by itself).
//   P3 queue_fetch: persistent warps drain a queue of n items through
//      exactly K4's fetch (warp_queue.cuh) with no work per item; each item
//      adds one to its count, so a count other than 1 is a queue fault.
//      Bound by the atomic on the one counter.
// A row's value is the xor of its 128 words; after step s a chain goes to
// row ((that xor + s * 0x9E3779B9) mod 2^32) mod the row count: the row's
// words decide it (the load cannot be skipped), and the step term keeps a
// chain from closing into a short cycle of cached rows. Launches go on the
// caller's stream and allocate nothing.

#include "warp_queue.cuh"

namespace {

using namespace ctl;

constexpr int kThreadsMb = 128;

__device__ __forceinline__ unsigned xor4(float4 q) {
  return __float_as_uint(q.x) ^ __float_as_uint(q.y) ^ __float_as_uint(q.z) ^
         __float_as_uint(q.w);
}

__device__ __forceinline__ unsigned row_xor(const float4* __restrict__ row) {
  unsigned h = 0u;
#pragma unroll
  for (int k = 0; k < 32; ++k) h ^= xor4(row[k]);
  return h;
}

__device__ __forceinline__ int next_row(unsigned h, int s, int n_rows) {
  return (int)((h + (unsigned)s * 0x9E3779B9u) % (unsigned)n_rows);
}

__global__ void __launch_bounds__(kThreadsMb)
chase_rows_kernel(const float4* __restrict__ table, int n_rows,
                  const int* __restrict__ idx0, int n_chains, int n_steps,
                  int* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    idx = next_row(row_xor(table + (size_t)idx * 32), s, n_rows);
  }
  out[c] = idx;
}

__global__ void __launch_bounds__(kThreadsMb)
chase_rows_shared_kernel(const float4* __restrict__ table, int n_rows,
                         const int* __restrict__ idx0, int n_chains,
                         int n_steps, int* __restrict__ out) {
  extern __shared__ float4 rows[];
  for (int i = threadIdx.x; i < n_rows * 32; i += blockDim.x) {
    const int r = i >> 5;
    rows[r * 32 + ((i & 31) ^ (r & 31))] = table[i];
  }
  __syncthreads();
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chains) return;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    const float4* row = rows + idx * 32;
    const int sw = idx & 31;
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < 32; ++k) h ^= xor4(row[k ^ sw]);
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

}  // namespace

// P1. shared != 0 stages the table in shared memory (n_rows * 512 bytes,
// at most 227 KB); returns a CUDA error code, or -1 if it does not fit.
extern "C" int ctl_chase_rows(const float* table, int n_rows, const int* idx0,
                              int n_chains, int n_steps, int shared, int* out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (n_chains <= 0) return (int)cudaGetLastError();
  if (shared) {
    const size_t bytes = (size_t)n_rows * 512;
    int dev = 0, limit = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes > (size_t)limit) return -1;
    cudaFuncSetAttribute(chase_rows_shared_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    chase_rows_shared_kernel<<<blocks_for(n_chains), kThreadsMb, bytes, s>>>(
        t4, n_rows, idx0, n_chains, n_steps, out);
  } else {
    chase_rows_kernel<<<blocks_for(n_chains), kThreadsMb, 0, s>>>(
        t4, n_rows, idx0, n_chains, n_steps, out);
  }
  return (int)cudaGetLastError();
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
