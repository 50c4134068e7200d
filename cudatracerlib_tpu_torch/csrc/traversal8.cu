// BVH8 fat-row traversal for NVIDIA Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel
// (and the XLA loop cudatracerlib_tpu/ops/traversal8.py::intersect_wide). It
// computes what that kernel computes: the closest hit (t, tri, u, v) of each
// ray against the unified 8-wide fat-row BVH, or any hit for shadow rays,
// with a per-ray root row and per-ray any-hit flag.
//
// Two variants compute it, bit for bit alike; the wrapper
// (ops/traversal8.py::intersect_wide_cuda) picks one from the table's size
// against the card's opt-in shared memory per block (227 KB, 454 fat rows on
// an H100):
//
// - shared (traverse8_shared_kernel), for a table that fits: one 512-thread
//   block per SM copies the table into shared memory, swizzled, with
//   cp.async (a microsecond or two), then each warp takes 32 rays at a time
//   from a queue (warp_queue.cuh) until it is drained. Rows are read with
//   LDS.128. On the main path this runs every launch on the Cornell and
//   veach-mis tables. The queue, not a static stride, hands out the rays:
//   rays come in pixel order, and a static stride gives each SM one patch
//   of the image, so the SMs with the costly patches finish last (the
//   stride measured 5-32% slower, csrc/schedule_probe.cu).
// - global (traverse8_kernel), for a larger table: one thread per ray in
//   128-thread blocks, rows from device memory through L1/L2
//   (LDG.E.128.CONSTANT), no size cap. These are flat tables of 455 to
//   2,048 rows and the 211,592-row San Miguel table. On the main path K1
//   meets that table only as the treelet path's whole-batch exactness
//   fallback, where every ray whose visits did not overflow has tmax -1 and
//   takes one step; the table is twice the L2 and ~470 times a block's
//   shared memory, so this regime keeps the global source.
//
// What bounds them on this card: not the row fetch. With no shared memory
// requested, the global variant's SM keeps up to 256 KB of L1, which holds a
// Cornell-class table whole, so both variants read a row at L1-like cost,
// and the two take about the same device time; the shared variant also
// zeroes its queue counter, a second operation per launch (PERF.md). The
// shared variant stays only until a benchmark cell shows where it wins
// (ROADMAP). Both are bound by issuing
// the per-lane state machine under divergence: a warp runs its node-step
// lanes and its leaf-step lanes one after the other, and waits for its
// slowest ray. Neither is near its bytes bound.
//
// The per-ray state machine (bvh8_traverse.cuh) is shared with K2, K3 and
// K4, and its plain PyTorch version is ops/traversal8.py::intersect_wide.
//
// A launch goes on the caller's stream and allocates nothing; the shared
// variant's queue counter is the caller's int32 scratch, zeroed on the
// stream before the launch.

#include "bvh8_traverse.cuh"

namespace {

using namespace ctl;

// Ray i from its root to its hit, from the row source `Rows` on `stack`.
template <class Rows, class Stack>
__device__ __forceinline__ void trace_ray(
    const float4* __restrict__ table, int n_rows, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const int* __restrict__ roots,
    const uint8_t* __restrict__ any_mask, int any_hit, int stack_depth,
    int max_iters, float* __restrict__ t_out, int* __restrict__ tri_out,
    float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ steps_out, uint8_t* __restrict__ flags_out, int i,
    Stack& stack) {
  const Ray r = load_ray(o, d, tmin, i);
  const bool anyh = any_hit || (any_mask != nullptr && any_mask[i] != 0);
  Best b{tmax[i], -1, 0.0f, 0.0f};
  int steps = 0;
  uint8_t flags = 0;
  NoVisit none;
  traverse<Rows>(table, n_rows, kNoVirtual, r,
                 ((roots != nullptr ? roots[i] : 0) << 8) | 0xFF, anyh,
                 stack_depth, max_iters, b, steps, flags, none, stack);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  steps_out[i] = steps;
  flags_out[i] = flags;
}

#define CTL_K1_PARAMS                                                         \
  const float4 *__restrict__ table, int n_rows, const float *__restrict__ o,  \
      const float *__restrict__ d, const float *__restrict__ tmin,            \
      const float *__restrict__ tmax, const int *__restrict__ roots,          \
      const uint8_t *__restrict__ any_mask, int n_rays, int any_hit,          \
      int stack_depth, int max_iters, float *__restrict__ t_out,              \
      int *__restrict__ tri_out, float *__restrict__ u_out,                   \
      float *__restrict__ v_out, int *__restrict__ steps_out,                 \
      uint8_t *__restrict__ flags_out
#define CTL_K1_ARGS(TABLE)                                                    \
  TABLE, n_rows, o, d, tmin, tmax, roots, any_mask, any_hit, stack_depth,     \
      max_iters, t_out, tri_out, u_out, v_out, steps_out, flags_out

// The global variant: one thread per ray, rows from device memory.
__global__ void __launch_bounds__(kThreads) traverse8_kernel(CTL_K1_PARAMS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int stack[kMaxStack];
  trace_ray<GlobalRows>(CTL_K1_ARGS(table), i, stack);
}

// The shared variant: one block per SM stages the table, then each warp
// takes 32 rays at a time from the launch's queue (warp_queue.cuh), its
// lanes one ray each, until the queue is drained.
__global__ void __launch_bounds__(kPersistThreads, 1)
traverse8_shared_kernel(CTL_K1_PARAMS, int* next_ray) {
  extern __shared__ float4 smem[];
  stage_rows(smem, table, n_rows);
  int stack[kMaxStack];
  bool drained = false;
  while (!drained) {  // warp-uniform
    const int i = warp_fetch(next_ray, true, n_rays, drained);
    if (i < 0) continue;
    trace_ray<SharedRows>(CTL_K1_ARGS(smem), i, stack);
  }
}

}  // namespace

// variant: 0 global; 1 shared. next_ray: the shared variant's queue
// counter, an int32 of the caller's, zeroed here on the stream (unused by
// the global variant). Returns a CUDA error code, or -1 for another
// variant.
extern "C" int ctl_traverse8(const float* table, int n_rows, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, const int* roots,
                             const uint8_t* any_mask, int n_rays, int any_hit,
                             int stack_depth, int max_iters, float* t_out,
                             int* tri_out, float* u_out, float* v_out,
                             int* steps_out, uint8_t* flags_out, int* next_ray,
                             int variant, void* stream) {
  if (variant < 0 || variant > 1) return -1;
  if (n_rays <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (variant == 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    traverse8_kernel<<<blocks, kThreads, 0, s>>>(
        t4, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
        stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
        flags_out);
    return (int)cudaGetLastError();
  }
  static SharedOptIn opt;
  return launch_shared(traverse8_shared_kernel, opt, kPersistThreads,
                       (size_t)n_rows * 512, n_rays, next_ray, s, t4, n_rows,
                       o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
                       stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                       steps_out, flags_out);
}
