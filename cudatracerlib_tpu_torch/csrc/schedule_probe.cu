// The designs that the shared variants of K1 and K2 (traversal8.cu,
// traversal_tt.cu) were measured against. On no render path: the wrappers
// in utils/schedule_probe.py launch them, and chip_smoke.py holds them to
// the plain versions and times them beside the kept variants, on the same
// rays in the same process (PERF.md, section 6).
//
// Each runs the kept kernels' per-ray code (trace_ray, top_ray) on the
// swizzled table in shared memory, one 512-thread block per SM, and
// changes one thing:
// - design 0, "stride": rays by a static stride (ray = the thread's index
//   in the grid + k * the grid's threads) instead of the per-warp queue;
//   the stacks in local memory, as kept;
// - design 1, "smem_stack": the per-warp queue, as kept, with each
//   thread's ring stack in shared memory after the table, one column per
//   thread (stack_depth * 4 * 512 more bytes per block).
// Both compute what the kept variants compute, bit for bit.

#include "traversal8.cu"
#include "traversal_tt.cu"

namespace {

using namespace ctl;

constexpr int kStride = 0;
constexpr int kSmemStack = 1;

// A ring stack in shared memory with one column per thread: entry k of
// thread t is word k * kPersistThreads + t of the block's stack area, so
// the lanes of a warp fall on 32 different banks whatever entries they
// touch.
struct SharedStack {
  int* base;  // the block's stack area + threadIdx.x

  __device__ __forceinline__ int& operator[](int k) const {
    return base[k * kPersistThreads];
  }
};

template <int kDesign>
__global__ void __launch_bounds__(kPersistThreads, 1)
probe_traverse8_kernel(CTL_K1_PARAMS, int* next_ray) {
  extern __shared__ float4 smem[];
  stage_rows(smem, table, n_rows);
  if constexpr (kDesign == kStride) {
    int stack[kMaxStack];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
         i += gridDim.x * blockDim.x) {
      trace_ray<SharedRows>(CTL_K1_ARGS(smem), i, stack);
    }
  } else {
    SharedStack stack{reinterpret_cast<int*>(smem + n_rows * 32) +
                      threadIdx.x};
    bool drained = false;
    while (!drained) {  // warp-uniform
      const int i = warp_fetch(next_ray, true, n_rays, drained);
      if (i >= 0) trace_ray<SharedRows>(CTL_K1_ARGS(smem), i, stack);
    }
  }
}

template <int V, int kDesign>
__global__ void __launch_bounds__(kPersistThreads, 1)
probe_top_visits_kernel(CTL_K2_PARAMS, int* next_ray) {
  extern __shared__ float4 smem[];
  stage_rows(smem, top, n_top);
  if constexpr (kDesign == kStride) {
    int stack[kMaxStack];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays;
         i += gridDim.x * blockDim.x) {
      top_ray<V, SharedRows>(CTL_K2_ARGS(smem), i, stack);
    }
  } else {
    SharedStack stack{reinterpret_cast<int*>(smem + n_top * 32) +
                      threadIdx.x};
    bool drained = false;
    while (!drained) {  // warp-uniform
      const int i = warp_fetch(next_ray, true, n_rays, drained);
      if (i >= 0) top_ray<V, SharedRows>(CTL_K2_ARGS(smem), i, stack);
    }
  }
}

// Launches `kernel` for `design`: the stride design on shared_grid's grid
// with the table's bytes, the smem_stack design through launch_shared with
// the stacks' bytes added (it zeroes the queue counter).
template <class Kernel, class... Args>
int launch_design(Kernel kernel, SharedOptIn& opt, int design, int n_rows,
                  int stack_depth, int n_rays, int* next_ray,
                  cudaStream_t stream, Args... args) {
  size_t bytes = (size_t)n_rows * 512;
  if (design == kSmemStack) {
    bytes += (size_t)stack_depth * 4 * kPersistThreads;
    return launch_shared(kernel, opt, kPersistThreads, bytes, n_rays,
                         next_ray, stream, args...);
  }
  int blocks = 0;
  const int err =
      shared_grid(kernel, opt, kPersistThreads, bytes, n_rays, &blocks);
  if (err != 0) return err;
  kernel<<<blocks, kPersistThreads, bytes, stream>>>(args..., next_ray);
  return (int)cudaGetLastError();
}

template <int V>
int launch_probe_top(int design, const float4* top, int n_top,
                     const float* o, const float* d, const float* tmin,
                     const float* tmax, const uint8_t* any_mask, int n_rays,
                     int any_hit, int stack_depth, int max_iters,
                     float* t_out, int* tri_out, float* u_out, float* v_out,
                     int* steps_out, uint8_t* flags_out, int* vid_out,
                     float* vent_out, int* vcnt_out, float* mdrop_out,
                     int* next_ray, cudaStream_t stream) {
  static SharedOptIn opt[2];
  auto kernel = design == kStride ? probe_top_visits_kernel<V, kStride>
                                  : probe_top_visits_kernel<V, kSmemStack>;
  return launch_design(kernel, opt[design], design, n_top, stack_depth,
                       n_rays, next_ray, stream, top, n_top, o, d, tmin, tmax,
                       any_mask, n_rays, any_hit, stack_depth, max_iters,
                       t_out, tri_out, u_out, v_out, steps_out, flags_out,
                       vid_out, vent_out, vcnt_out, mdrop_out);
}

}  // namespace

// ctl_traverse8's arguments, with `design` (0 stride, 1 smem_stack) in
// place of the variant. Returns a CUDA error code, or -1 for another
// design.
extern "C" int ctl_probe_traverse8(
    const float* table, int n_rows, const float* o, const float* d,
    const float* tmin, const float* tmax, const int* roots,
    const uint8_t* any_mask, int n_rays, int any_hit, int stack_depth,
    int max_iters, float* t_out, int* tri_out, float* u_out, float* v_out,
    int* steps_out, uint8_t* flags_out, int* next_ray, int design,
    void* stream) {
  if (design != kStride && design != kSmemStack) return -1;
  if (n_rays <= 0) return (int)cudaGetLastError();
  static SharedOptIn opt[2];
  auto kernel = design == kStride ? probe_traverse8_kernel<kStride>
                                  : probe_traverse8_kernel<kSmemStack>;
  return launch_design(kernel, opt[design], design, n_rows, stack_depth,
                       n_rays, next_ray, (cudaStream_t)stream,
                       reinterpret_cast<const float4*>(table), n_rows, o, d,
                       tmin, tmax, roots, any_mask, n_rays, any_hit,
                       stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                       steps_out, flags_out);
}

// ctl_top_visits's arguments, with `design` in place of the variant.
extern "C" int ctl_probe_top_visits(
    const float* top, int n_top, const float* o, const float* d,
    const float* tmin, const float* tmax, const uint8_t* any_mask,
    int n_rays, int any_hit, int V, int stack_depth, int max_iters,
    float* t_out, int* tri_out, float* u_out, float* v_out, int* steps_out,
    uint8_t* flags_out, int* vid_out, float* vent_out, int* vcnt_out,
    float* mdrop_out, int* next_ray, int design, void* stream) {
  if ((V != 3 && V != 6) || (design != kStride && design != kSmemStack)) {
    return -1;
  }
  if (n_rays <= 0) return (int)cudaGetLastError();
  auto launch = V == 3 ? launch_probe_top<3> : launch_probe_top<6>;
  return launch(design, reinterpret_cast<const float4*>(top), n_top, o, d,
                tmin, tmax, any_mask, n_rays, any_hit, stack_depth,
                max_iters, t_out, tri_out, u_out, v_out, steps_out, flags_out,
                vid_out, vent_out, vcnt_out, mdrop_out, next_ray,
                (cudaStream_t)stream);
}
