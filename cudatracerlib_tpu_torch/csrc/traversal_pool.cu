// BVH8 fat-row traversal from a global ray queue for NVIDIA Hopper
// (sm_90a): kernel K4.
//
// Replaces the TPU kernel cudatracerlib_tpu/ops/traversal_pl.py::
// _traverse_kernel_pool (wrapper intersect_pallas_pool). It computes K1's
// function (traversal8.cu): the closest hit (t, tri, u, v) of each ray, or
// any hit per ray (any_hit or any_mask), from per-ray roots, with per-ray
// step counts and flags (bit 0 capped at max_iters steps, bit 1 stack
// overflow). Its results are bit-identical to K1's on every field, for any
// order of the rays; its plain PyTorch version is K1's,
// ops/traversal8.py::intersect_wide.
//
// What bounds it on this card, as K1: warp divergence (each lane runs its
// own data-dependent loop) and the latency of dependent 512-byte row loads
// from L1/L2 (a small table stays cached), not device-memory bandwidth.
//
// What the queue changes: in K1 a warp holds its 32 rays until the slowest
// is done, so its finished lanes idle. Here the grid is persistent (as many
// 128-thread blocks as fit on every SM at once) and each lane that finishes
// a ray takes the next unstarted ray of the whole batch between two steps,
// through warp_queue.cuh (ballot, one atomicAdd per warp, shfl): the
// Aila-Laine persistent threads of the original library, and the
// counterpart of the TPU kernel's lane prefix sum. A warp leaves when the
// queue is drained and all its lanes are done. Each lane writes its
// results to its ray's own slot, so the TPU kernel's one-hot scatter and the
// host un-permute are not needed.
//
// The per-ray state machine is bvh8_traverse.cuh's (init, step), shared
// with K1, K2 and K3. The queue counter is the caller's int32 scratch; the C
// entry zeroes it on the caller's stream before the launch, so back-to-back
// launches on one scratch each take every ray. The launch allocates nothing
// and does not synchronise.

#include "bvh8_traverse.cuh"
#include "warp_queue.cuh"

namespace {

using namespace ctl;

__global__ void __launch_bounds__(kThreads)
traverse_pool_kernel(const float4* __restrict__ table, int n_rows,
                     const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin,
                     const float* __restrict__ tmax,
                     const int* __restrict__ roots,
                     const uint8_t* __restrict__ any_mask, int n_rays,
                     int any_hit, int stack_depth, int max_iters,
                     float* __restrict__ t_out, int* __restrict__ tri_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ steps_out,
                     uint8_t* __restrict__ flags_out, int* next_ray) {
  int ray = -1;  // the lane's ray, -1 while it has none
  int cur = kDone, steps = 0;
  uint8_t flags = 0;
  bool anyh = false;
  Ray r{};
  Best b{};
  int stack[kMaxStack];
  Walk w;
  NoVisit none;
  bool drained = false;
  // warp-uniform: every lane reaches each warp_fetch and __any_sync
  while (true) {
    if (ray >= 0 && (cur == kDone || steps >= max_iters)) {
      if (cur != kDone) flags |= 1;
      t_out[ray] = b.t;
      tri_out[ray] = b.tri;
      u_out[ray] = b.u;
      v_out[ray] = b.v;
      steps_out[ray] = steps;
      flags_out[ray] = flags;
      ray = -1;
    }
    const int id = warp_fetch(next_ray, ray < 0, n_rays, drained);
    if (id >= 0) {
      ray = id;
      r = load_ray(o, d, tmin, id);
      anyh = any_hit || (any_mask != nullptr && any_mask[id] != 0);
      b = Best{tmax[id], -1, 0.0f, 0.0f};
      cur = ((roots != nullptr ? roots[id] : 0) << 8) | 0xFF;
      steps = 0;
      flags = 0;
      w.init();
    }
    if (!__any_sync(kFullMask, ray >= 0) && drained) break;
    if (ray >= 0 && steps < max_iters) {
      ++steps;
      cur = step(table, n_rows, kNoVirtual, r, cur, anyh, stack_depth, stack,
                 w, b, flags, none);
    }
  }
}

}  // namespace

extern "C" int ctl_traverse_pool(const float* table, int n_rows,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const int* roots, const uint8_t* any_mask,
                                 int n_rays, int any_hit, int stack_depth,
                                 int max_iters, float* t_out, int* tri_out,
                                 float* u_out, float* v_out, int* steps_out,
                                 uint8_t* flags_out, int* next_ray,
                                 void* stream) {
  if (n_rays > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaMemsetAsync(next_ray, 0, sizeof(int), s);
    const int blocks =
        persistent_blocks(traverse_pool_kernel, kThreads, n_rays);
    traverse_pool_kernel<<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), n_rows, o, d, tmin, tmax,
        roots, any_mask, n_rays, any_hit, stack_depth, max_iters, t_out,
        tri_out, u_out, v_out, steps_out, flags_out, next_ray);
  }
  return (int)cudaGetLastError();
}
