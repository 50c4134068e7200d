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
// 3 (bounce and shadow rays) and 6 (camera rays). A ray starts at top row 0,
// or, given per-lane roots, at its own top-local row: an instanced scene's
// split forest holds one BLAS per shared mesh, and each instance visit
// starts at its BLAS root's top row (as K1 takes global roots).
//
// K3, one thread per visit slot: the caller sorts the B*V visit slots by
// packed key, so neighbouring threads traverse the same slab from the same
// or nearby roots. Each thread reads its ray by index and its slab by the
// visit's treelet id, starts at the visit's local root with tmax = the ray's
// prune t (the phase-1 hit, or -1 for an any-hit ray already hit) and writes
// its hit to the visit's own slot. Invalid slots (key >= n_treelets << 14)
// exit at once. Launched over all slots, so the caller needs no host read.
//
// K2 has two variants, picked by its own rule from the top table's size
// (ops/traversal_tt.py::top_variant; K1 and K4 keep theirs):
// - shared (top_visits_shared_kernel), for a top table that fits one
//   block's shared memory (454 rows, 227 KB on an H100; San Miguel's 240
//   rows at 1.2M triangles): one 512-thread block per SM holds the
//   swizzled table, its warps take 32 rays at a time from a queue, rows by
//   LDS.128;
// - split (top_visits_split_kernel<V>), for a larger one, up to the
//   partition's 2,048-row cap (998 rows at 4.8M triangles): a persistent
//   grid of one 512-thread block per SM stages rows 0-452 of the table
//   with cp.async (cluster_rows.cuh: SplitStage; the partition writes the
//   top's node rows first, so they hold the rows every ray reads) and
//   reads the rest through L1/L2; its warps drain the launch's ray queue,
//   kept in the stream's work area (warp_queue.cuh, as K4 and K1's group
//   design: no memset).
// A K2 ray takes some 17 steps in the top table (K1's rays on
// Cornell-class tables about 3), so the cheaper rows and the queue's
// balance show: on the 240-row table the shared variant is ahead of one
// thread per ray reading rows through L1/L2 by 5-12% of device time, and
// like K1 bound by issuing the state machine under divergence, not by
// bytes. On the 998-row table of the 4.8M-triangle stand-in (H100 80GB
// HBM3, 700.00 W; PERF.md) the split design was some 2% ahead of one
// thread per ray through L1/L2 and 8-10% ahead of the table over a
// cluster's shared memory at 4 or 8 blocks, read through its windows, over
// a PT pass's 48 calls (both designs are in csrc/schedule_probe.cu). It
// wins the heavy bounce calls by 5-8% and loses the light ones (camera
// rays, the shadow flush) by 10-25%: staging 227 KB on every SM costs
// some 7 us a launch. One thread reading a remote row as 16-byte generic
// loads waits longer than for one from L2, so the cluster design loses to
// both.
//
// K3 reads its slabs straight from device memory through L1 and L2: the
// 1.2M-triangle table's 414 slabs of 512 rows total ~109 MB, twice the
// 50 MB L2, and the sort's coherence (a warp's visits share a slab and
// nearby roots) keeps its row loads in cache; asking for no shared memory
// leaves the SM all of its L1. A visit takes some 4 steps. Staging each
// slab on chip for the visits that share it, as the TPU kernel does in
// VMEM, was built and measured (csrc/schedule_probe.cu: a slab over the
// shared memory of a cluster of 2 blocks read through distributed shared
// memory, or 453 of its rows in one block's): on the San Miguel slots both
// took 2.2-4.1x K3's device time, and so did the persistent chunk walk
// they need with nothing staged (PERF.md): the barrier that closes each
// staged segment makes the block or cluster wait for the slowest of some
// 1.5 visits per thread, and staging and walking alone cost 41% of K3. So
// K3 keeps one thread per slot; its blocks retire on their own.
//
// Their plain PyTorch versions are ops/traversal_tt.py::top_visits and
// ::treelet_hits. Launches go on the caller's stream and allocate nothing;
// K2's shared variant zeroes the caller's queue counter on the stream, its
// split variant counts in the caller's work area.

#include "bvh8_traverse.cuh"
#include "cluster_rows.cuh"
#include "warp_queue.cuh"

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
    const float* __restrict__ tmax, const int* __restrict__ roots,
    const uint8_t* __restrict__ any_mask, int any_hit, int stack_depth,
    int max_iters, float* __restrict__ t_out,
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
  traverse<Rows>(top, n_top, n_top, r,
                 ((roots != nullptr ? roots[i] : 0) << 8) | 0xFF, anyh,
                 stack_depth, max_iters, b, steps, flags, nv, stack);
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
      const float *__restrict__ tmax, const int *__restrict__ roots,         \
      const uint8_t *__restrict__ any_mask, int n_rays, int any_hit,         \
      int stack_depth, int max_iters,                                        \
      float *__restrict__ t_out, int *__restrict__ tri_out,                  \
      float *__restrict__ u_out, float *__restrict__ v_out,                  \
      int *__restrict__ steps_out, uint8_t *__restrict__ flags_out,          \
      int *__restrict__ vid_out, float *__restrict__ vent_out,               \
      int *__restrict__ vcnt_out, float *__restrict__ mdrop_out
#define CTL_K2_ARGS(TABLE)                                                   \
  TABLE, n_top, o, d, tmin, tmax, roots, any_mask, any_hit, stack_depth,    \
      max_iters,                                                             \
      t_out, tri_out, u_out, v_out, steps_out, flags_out, vid_out, vent_out, \
      vcnt_out, mdrop_out
// A K2 kernel's parameters passed on whole, as they came.
#define CTL_K2_FORWARD                                                       \
  top, n_top, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,           \
      stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,       \
      flags_out, vid_out, vent_out, vcnt_out, mdrop_out

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

// A launch's rays from a table staged on chip by the row source Stage over
// a cluster of kRanks blocks (one for SplitStage): each block stages its
// share, the cluster meets, the warps drain the queue counter in `work`
// (this launch's counter set; block 0 zeroes the other, `next`, for the
// launch after), and the cluster meets again before any block leaves, so
// that no block's share goes while another block may still read it.
template <int V, class Stage, int kRanks>
__device__ __forceinline__ void top_staged(CTL_K2_PARAMS,
                                           int* __restrict__ work,
                                           int* __restrict__ next) {
  zero_set(next);
  Stage::stage(top, n_top, cluster_rank<kRanks>());
  cluster_sync<kRanks>();
  int stack[kMaxStack];
  bool drained = false;
  while (!drained) {  // warp-uniform
    const int i = warp_fetch(work + kInput, true, n_rays, drained);
    if (i < 0) continue;
    top_ray<V, Stage>(CTL_K2_ARGS(Stage::table(top)), i, stack);
  }
  cluster_sync<kRanks>();
}

// The split variant: rows 0-452 of the top table in each block's shared
// memory, the rest through L1/L2.
template <int V>
__global__ void __launch_bounds__(kPersistThreads, 1)
top_visits_split_kernel(CTL_K2_PARAMS, int* __restrict__ work,
                        int* __restrict__ next) {
  top_staged<V, SplitStage, 1>(CTL_K2_FORWARD, work, next);
}

#define CTL_K3_PARAMS                                                         \
  const float4 *__restrict__ slabs, int n_treelets, int rows,                 \
      const float *__restrict__ o, const float *__restrict__ d,               \
      const float *__restrict__ tmin, const float *__restrict__ t_prune,      \
      const uint8_t *__restrict__ any_mask, int any_hit,                      \
      const int *__restrict__ keys, const int *__restrict__ order,            \
      int n_visits, int V, int stack_depth, int max_iters,                    \
      float *__restrict__ t_out, int *__restrict__ tri_out,                   \
      float *__restrict__ u_out, float *__restrict__ v_out,                   \
      int *__restrict__ steps_out, uint8_t *__restrict__ flags_out
#define CTL_K3_ARGS                                                           \
  slabs, n_treelets, rows, o, d, tmin, t_prune, any_mask, any_hit, keys,      \
      order, n_visits, V, stack_depth, max_iters, t_out, tri_out, u_out,      \
      v_out, steps_out, flags_out

// Sorted slot i: its visit from the visit's local root, pruned by its ray's
// t, its rows read from `table` through the source Rows (K3: the visit's
// slab in device memory), written to the visit's own slot. An invalid slot
// (its treelet id past the last) writes t=inf, tri=-1, 0 steps, no flags.
template <class Rows, class Stack>
__device__ __forceinline__ void treelet_visit(CTL_K3_PARAMS,
                                              const float4* table, int i,
                                              Stack& stack) {
  const int key = keys[i];
  const int slot = order[i];
  Best b{__int_as_float(0x7f800000), -1, 0.0f, 0.0f};
  int steps = 0;
  uint8_t flags = 0;
  if ((key >> kVidRootBits) < n_treelets) {
    const int ray = slot / V;
    const Ray r = load_ray(o, d, tmin, ray);
    const bool anyh = any_hit || (any_mask != nullptr && any_mask[ray] != 0);
    b.t = t_prune[ray];
    const int root = key & ((1 << kVidRootBits) - 1);
    NoVisit none;
    traverse<Rows>(table, rows, kNoVirtual, r, (root << 8) | 0xFF, anyh,
                   stack_depth, max_iters, b, steps, flags, none, stack);
  }
  t_out[slot] = b.t;
  tri_out[slot] = b.tri;
  u_out[slot] = b.u;
  v_out[slot] = b.v;
  steps_out[slot] = steps;
  flags_out[slot] = flags;
}

// The slab of sorted slot i's visit in device memory.
__device__ __forceinline__ const float4* visit_slab(
    const float4* __restrict__ slabs, int rows,
    const int* __restrict__ keys, int i) {
  return slabs + (size_t)(keys[i] >> kVidRootBits) * rows * 32;
}

// K3: one thread per slot, every slab from device memory.
__global__ void __launch_bounds__(kThreads)
treelet_hits_kernel(CTL_K3_PARAMS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_visits) return;
  int stack[kMaxStack];
  treelet_visit<GlobalRows>(CTL_K3_ARGS, visit_slab(slabs, rows, keys, i), i,
                            stack);
}

// Launches the split variant on shared_grid's grid (one block per SM, no
// more than the rays need), counting in set `set` of the work area `work`
// (warp_queue.cuh), which must be zero.
template <int V>
int launch_top_split(CTL_K2_PARAMS, int* work, int set, cudaStream_t stream) {
  static SharedOptIn opt;
  const size_t bytes = SplitStage::bytes(n_top);
  int blocks = 0;
  const int err = shared_grid(top_visits_split_kernel<V>, opt,
                              kPersistThreads, bytes, n_rays, &blocks);
  if (err != 0) return err;
  top_visits_split_kernel<V><<<blocks, kPersistThreads, bytes, stream>>>(
      CTL_K2_FORWARD, work + kSet * set, work + kSet * (1 - set));
  return (int)cudaGetLastError();
}

template <int V>
int launch_top(int variant, int set, CTL_K2_PARAMS, int* scratch,
               cudaStream_t stream) {
  if (variant == 1) {
    return launch_top_split<V>(CTL_K2_FORWARD, scratch, set, stream);
  }
  static SharedOptIn opt;
  return launch_shared(top_visits_shared_kernel<V>, opt, kPersistThreads,
                       (size_t)n_top * 512, n_rays, scratch, stream,
                       CTL_K2_FORWARD);
}

}  // namespace

// roots (nullable: every ray starts at top row 0) holds each ray's
// top-local start row, as ctl_traverse8's roots. variant: 0 shared, 1
// split. scratch: the shared variant's queue counter (an int32, zeroed
// here on the stream), or the split variant's work area (warp_queue.cuh;
// at least kWork int32), counting in its set `set` (0 or 1, zero).
// Returns a CUDA error code (a block the card cannot hold is refused), or
// -1 for a V other than 3 and 6, or another variant or set.
extern "C" int ctl_top_visits(const float* top, int n_top, const float* o,
                              const float* d, const float* tmin,
                              const float* tmax, const int* roots,
                              const uint8_t* any_mask,
                              int n_rays, int any_hit, int V, int stack_depth,
                              int max_iters, float* t_out, int* tri_out,
                              float* u_out, float* v_out, int* steps_out,
                              uint8_t* flags_out, int* vid_out,
                              float* vent_out, int* vcnt_out,
                              float* mdrop_out, int* scratch, int variant,
                              int set, void* stream) {
  if ((V != 3 && V != 6) || variant < 0 || variant > 1 || set < 0 ||
      set > 1) {
    return -1;
  }
  if (n_rays <= 0) return (int)cudaGetLastError();
  auto launch = V == 3 ? launch_top<3> : launch_top<6>;
  return launch(variant, set, reinterpret_cast<const float4*>(top),
                n_top, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
                stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                steps_out, flags_out, vid_out, vent_out, vcnt_out, mdrop_out,
                scratch, (cudaStream_t)stream);
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
