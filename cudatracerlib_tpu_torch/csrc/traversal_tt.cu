// Two-phase treelet traversal for NVIDIA Hopper (sm_90a): kernels K2 and K3.
//
// Replace the TPU kernels cudatracerlib_tpu/ops/traversal_tt.py::_top_kernel
// (K2, phase 1) and ::_treelet_kernel (K3, phase 2). Large scenes split their
// fat-row table into a small TOP table and treelet slabs (scene/treelet.py);
// a top-table leaf at or beyond the top's row count is a virtual leaf naming
// a visit id = (treelet id << 14) | local root row.
//
// K2, one thread per ray: traverse the top table. Real top leaves update the
// ray's best hit; each virtual leaf is a visit, kept with the entry t of the
// descend that reached it. The ray keeps its V NEAREST visits: once V are
// held, a new visit replaces the farthest kept one (lowest slot among equal
// maxima) only if it is closer, and the smallest entry t among the dropped
// visits is tracked, so the caller knows which rays may have lost a hit.
// V is a template parameter, instantiated for the two budgets the path uses:
// 3 (bounce and shadow rays) and 6 (camera rays).
//
// K3, one thread per visit slot: the caller sorts the B*V visit slots by
// packed key, so neighbouring threads traverse the same slab from the same
// or nearby roots. Each thread reads its ray by index and its slab by the
// visit's treelet id, starts at the visit's local root with tmax = the ray's
// prune t (the phase-1 hit, or -1 for an any-hit ray already hit) and writes
// its hit to the visit's own slot. Invalid slots (key >= n_treelets << 14)
// exit at once. Launched over all slots, so the caller needs no host read.
//
// K2 has K1's two variants (traversal8.cu), picked by the same rule from
// the top table's size: shared (top_visits_shared_kernel: one 512-thread
// block per SM holds the swizzled top table in shared memory, its warps
// take 32 rays at a time from a queue, rows by LDS.128) for a top table
// that fits a block's shared memory, which San Miguel's 240 rows (123 KB)
// do; global (top_visits_kernel: one thread per ray, rows through L1/L2)
// for a larger one, up to the partition's 2,048-row cap. A K2 ray takes
// some 17 steps in the top table (K1's rays on Cornell-class tables about
// 3), so the cheaper rows and the queue's balance show: the shared variant
// is ahead of the global one by 5-12% of device time (PERF.md), and like
// K1 bound by issuing the state machine under divergence, not by bytes.
//
// K3 stays on the global source: its 512-row slabs are 256 KB, over the
// 227 KB a block may hold, and a block's threads read many slabs (one per
// visit). It reads them straight from device memory through L1 and L2; the
// 1.2M-triangle table's slabs total ~109 MB, twice the 50 MB L2, so the
// sort's coherence is what keeps K3's row loads in cache. It is bound by
// divergence and dependent-load latency.
//
// Their plain PyTorch versions are ops/traversal_tt.py::top_visits and
// ::treelet_hits. Launches go on the caller's stream and allocate nothing;
// K2's shared variant zeroes the caller's queue counter on the stream.

#include "bvh8_traverse.cuh"

namespace {

using namespace ctl;

constexpr int kVidRootBits = 14;

template <int V>
struct NearestVisits {
  int vid[V];
  float vent[V];
  int count;
  float mdrop;

  __device__ __forceinline__ NearestVisits() {
    count = 0;
    mdrop = __builtin_huge_valf();
#pragma unroll
    for (int k = 0; k < V; ++k) {
      vid[k] = -1;
      vent[k] = 0.0f;
    }
  }

  __device__ __forceinline__ void put(int slot, int id, float t) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k == slot) {
        vid[k] = id;
        vent[k] = t;
      }
    }
  }

  __device__ __forceinline__ void operator()(int id, float tent) {
    if (count < V) {
      put(count, id, tent);
    } else {
      float t_far = vent[0];
      int j_far = 0;
#pragma unroll
      for (int k = 1; k < V; ++k) {
        if (vent[k] > t_far) {
          t_far = vent[k];
          j_far = k;
        }
      }
      float dropped = tent;
      if (tent < t_far) {
        put(j_far, id, tent);
        dropped = t_far;
      }
      mdrop = minp(mdrop, dropped);
    }
    ++count;
  }
};

// Ray i through the top table from the row source `Rows` on `stack`.
template <int V, class Rows, class Stack>
__device__ __forceinline__ void top_ray(
    const float4* __restrict__ top, int n_top, const float* __restrict__ o,
    const float* __restrict__ d, const float* __restrict__ tmin,
    const float* __restrict__ tmax, const uint8_t* __restrict__ any_mask,
    int any_hit, int stack_depth, int max_iters, float* __restrict__ t_out,
    int* __restrict__ tri_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ steps_out,
    uint8_t* __restrict__ flags_out, int* __restrict__ vid_out,
    float* __restrict__ vent_out, int* __restrict__ vcnt_out,
    float* __restrict__ mdrop_out, int i, Stack& stack) {
  const Ray r = load_ray(o, d, tmin, i);
  const bool anyh = any_hit || (any_mask != nullptr && any_mask[i] != 0);
  Best b{tmax[i], -1, 0.0f, 0.0f};
  int steps = 0;
  uint8_t flags = 0;
  NearestVisits<V> nv;
  traverse<Rows>(top, n_top, n_top, r, 0xFF, anyh, stack_depth, max_iters, b,
                 steps, flags, nv, stack);
  t_out[i] = b.t;
  tri_out[i] = b.tri;
  u_out[i] = b.u;
  v_out[i] = b.v;
  steps_out[i] = steps;
  flags_out[i] = flags;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    vid_out[(size_t)i * V + k] = nv.vid[k];
    vent_out[(size_t)i * V + k] = nv.vent[k];
  }
  vcnt_out[i] = nv.count;
  mdrop_out[i] = nv.mdrop;
}

#define CTL_K2_PARAMS                                                        \
  const float4 *__restrict__ top, int n_top, const float *__restrict__ o,    \
      const float *__restrict__ d, const float *__restrict__ tmin,           \
      const float *__restrict__ tmax, const uint8_t *__restrict__ any_mask,  \
      int n_rays, int any_hit, int stack_depth, int max_iters,               \
      float *__restrict__ t_out, int *__restrict__ tri_out,                  \
      float *__restrict__ u_out, float *__restrict__ v_out,                  \
      int *__restrict__ steps_out, uint8_t *__restrict__ flags_out,          \
      int *__restrict__ vid_out, float *__restrict__ vent_out,               \
      int *__restrict__ vcnt_out, float *__restrict__ mdrop_out
#define CTL_K2_ARGS(TABLE)                                                   \
  TABLE, n_top, o, d, tmin, tmax, any_mask, any_hit, stack_depth, max_iters, \
      t_out, tri_out, u_out, v_out, steps_out, flags_out, vid_out, vent_out, \
      vcnt_out, mdrop_out

// The global variant: one thread per ray, top rows from device memory.
template <int V>
__global__ void __launch_bounds__(kThreads) top_visits_kernel(CTL_K2_PARAMS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int stack[kMaxStack];
  top_ray<V, GlobalRows>(CTL_K2_ARGS(top), i, stack);
}

// The shared variant, as K1's (traversal8.cu): one block per SM stages the
// top table, then each warp takes 32 rays at a time from the launch's queue.
template <int V>
__global__ void __launch_bounds__(kPersistThreads, 1)
top_visits_shared_kernel(CTL_K2_PARAMS, int* next_ray) {
  extern __shared__ float4 smem[];
  stage_rows(smem, top, n_top);
  int stack[kMaxStack];
  bool drained = false;
  while (!drained) {  // warp-uniform
    const int i = warp_fetch(next_ray, true, n_rays, drained);
    if (i < 0) continue;
    top_ray<V, SharedRows>(CTL_K2_ARGS(smem), i, stack);
  }
}

__global__ void __launch_bounds__(kThreads)
treelet_hits_kernel(const float4* __restrict__ slabs, int n_treelets,
                    int rows, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ t_prune,
                    const uint8_t* __restrict__ any_mask, int any_hit,
                    const int* __restrict__ keys,
                    const int* __restrict__ order, int n_visits, int V,
                    int stack_depth, int max_iters, float* __restrict__ t_out,
                    int* __restrict__ tri_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ steps_out,
                    uint8_t* __restrict__ flags_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_visits) return;
  const int key = keys[i];
  const int slot = order[i];
  const int tid = key >> kVidRootBits;
  Best b{__int_as_float(0x7f800000), -1, 0.0f, 0.0f};
  int steps = 0;
  uint8_t flags = 0;
  if (tid < n_treelets) {
    const int ray = slot / V;
    const Ray r = load_ray(o, d, tmin, ray);
    const bool anyh = any_hit || (any_mask != nullptr && any_mask[ray] != 0);
    b.t = t_prune[ray];
    const int root = key & ((1 << kVidRootBits) - 1);
    NoVisit none;
    traverse(slabs + (size_t)tid * rows * 32, rows, kNoVirtual, r,
             (root << 8) | 0xFF, anyh, stack_depth, max_iters, b, steps, flags,
             none);
  }
  t_out[slot] = b.t;
  tri_out[slot] = b.tri;
  u_out[slot] = b.u;
  v_out[slot] = b.v;
  steps_out[slot] = steps;
  flags_out[slot] = flags;
}

template <int V>
int launch_top(int variant, const float* top, int n_top, const float* o,
               const float* d, const float* tmin, const float* tmax,
               const uint8_t* any_mask, int n_rays, int any_hit,
               int stack_depth, int max_iters, float* t_out, int* tri_out,
               float* u_out, float* v_out, int* steps_out, uint8_t* flags_out,
               int* vid_out, float* vent_out, int* vcnt_out, float* mdrop_out,
               int* next_ray, cudaStream_t stream) {
  const float4* t4 = reinterpret_cast<const float4*>(top);
  if (variant == 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    top_visits_kernel<V><<<blocks, kThreads, 0, stream>>>(
        t4, n_top, o, d, tmin, tmax, any_mask, n_rays, any_hit, stack_depth,
        max_iters, t_out, tri_out, u_out, v_out, steps_out, flags_out, vid_out,
        vent_out, vcnt_out, mdrop_out);
    return (int)cudaGetLastError();
  }
  static SharedOptIn opt;
  return launch_shared(top_visits_shared_kernel<V>, opt, kPersistThreads,
                       (size_t)n_top * 512, n_rays, next_ray, stream, t4,
                       n_top, o, d, tmin, tmax, any_mask, n_rays, any_hit,
                       stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                       steps_out, flags_out, vid_out, vent_out, vcnt_out,
                       mdrop_out);
}

}  // namespace

// variant (0 global, 1 shared) and next_ray as ctl_traverse8's. Returns a
// CUDA error code, or -1 for a V other than 3 and 6 or another variant.
extern "C" int ctl_top_visits(const float* top, int n_top, const float* o,
                              const float* d, const float* tmin,
                              const float* tmax, const uint8_t* any_mask,
                              int n_rays, int any_hit, int V, int stack_depth,
                              int max_iters, float* t_out, int* tri_out,
                              float* u_out, float* v_out, int* steps_out,
                              uint8_t* flags_out, int* vid_out,
                              float* vent_out, int* vcnt_out,
                              float* mdrop_out, int* next_ray, int variant,
                              void* stream) {
  if ((V != 3 && V != 6) || variant < 0 || variant > 1) return -1;
  if (n_rays <= 0) return (int)cudaGetLastError();
  auto launch = V == 3 ? launch_top<3> : launch_top<6>;
  return launch(variant, top, n_top, o, d, tmin, tmax, any_mask, n_rays,
                any_hit, stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                steps_out, flags_out, vid_out, vent_out, vcnt_out, mdrop_out,
                next_ray, (cudaStream_t)stream);
}

extern "C" int ctl_treelet_hits(const float* slabs, int n_treelets, int rows,
                                const float* o, const float* d,
                                const float* tmin, const float* t_prune,
                                const uint8_t* any_mask, int any_hit,
                                const int* keys, const int* order,
                                int n_visits, int V, int stack_depth,
                                int max_iters, float* t_out, int* tri_out,
                                float* u_out, float* v_out, int* steps_out,
                                uint8_t* flags_out, void* stream) {
  if (n_visits > 0) {
    const int blocks = (n_visits + kThreads - 1) / kThreads;
    treelet_hits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(slabs), n_treelets, rows, o, d, tmin,
        t_prune, any_mask, any_hit, keys, order, n_visits, V, stack_depth,
        max_iters, t_out, tri_out, u_out, v_out, steps_out, flags_out);
  }
  return (int)cudaGetLastError();
}
