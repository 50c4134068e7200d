// BVH8 fat-row traversal for NVIDIA Hopper (sm_90a): kernel K1.
//
// Replaces the TPU kernel cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel
// (and the XLA loop cudatracerlib_tpu/ops/traversal8.py::intersect_wide). It
// computes what that kernel computes: the closest hit (t, tri, u, v) of each
// ray against the unified 8-wide fat-row BVH, or any hit for shadow rays,
// with a per-ray root row and per-ray any-hit flag.
//
// What bounds it on this card: a Cornell-class table is a few hundred 512-byte
// rows, so it sits in L1/L2 after the first touches. The kernel is bound by
// warp divergence (each thread runs its own data-dependent loop) and by the
// latency of the dependent row loads, not by device-memory bandwidth.
//
// The design is simple on purpose; making it fast is later work: one thread
// per ray, a private ring stack in local memory, the table (R, 128) row-major
// in device memory with no size cap and no transpose. The per-ray state
// machine (bvh8_traverse.cuh) is shared with K2 and K3 (traversal_tt.cu), and
// its plain PyTorch version is ops/traversal8.py::intersect_wide.
//
// The launch goes on the caller's stream and allocates nothing.

#include "bvh8_traverse.cuh"

namespace {

using namespace ctl;

__global__ void __launch_bounds__(kThreads)
traverse8_kernel(const float4* __restrict__ table, int n_rows,
                 const float* __restrict__ o, const float* __restrict__ d,
                 const float* __restrict__ tmin, const float* __restrict__ tmax,
                 const int* __restrict__ roots,
                 const uint8_t* __restrict__ any_mask, int n_rays, int any_hit,
                 int stack_depth, int max_iters, float* __restrict__ t_out,
                 int* __restrict__ tri_out, float* __restrict__ u_out,
                 float* __restrict__ v_out, int* __restrict__ steps_out,
                 uint8_t* __restrict__ flags_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = load_ray(o, d, tmin, i);
  const bool anyh = any_hit || (any_mask != nullptr && any_mask[i] != 0);
  Best b{tmax[i], -1, 0.0f, 0.0f};
  int steps = 0;
  uint8_t flags = 0;
  NoVisit none;
  traverse(table, n_rows, kNoVirtual, r,
           ((roots != nullptr ? roots[i] : 0) << 8) | 0xFF, anyh, stack_depth,
           max_iters, b, steps, flags, none);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  steps_out[i] = steps;
  flags_out[i] = flags;
}

}  // namespace

extern "C" int ctl_traverse8(const float* table, int n_rows, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, const int* roots,
                             const uint8_t* any_mask, int n_rays, int any_hit,
                             int stack_depth, int max_iters, float* t_out,
                             int* tri_out, float* u_out, float* v_out,
                             int* steps_out, uint8_t* flags_out,
                             void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    traverse8_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(table), n_rows, o, d, tmin, tmax,
        roots, any_mask, n_rays, any_hit, stack_depth, max_iters, t_out,
        tri_out, u_out, v_out, steps_out, flags_out);
  }
  return (int)cudaGetLastError();
}
