// The designs that the shared variants of K1 and K2 (traversal8.cu,
// traversal_tt.cu) and K3 were measured against. On no render path: the
// wrappers in utils/schedule_probe.py launch them, and chip_smoke.py holds
// them to the plain versions and times them beside the kept kernels, on
// the same rays in the same process (PERF.md, section 6).
//
// K1's and K2's run the kept kernels' per-ray code (trace_ray, top_ray) on
// the swizzled table in shared memory, one 512-thread block per SM, and
// change one thing:
// - design 0, "stride": rays by a static stride (ray = the thread's index
//   in the grid + k * the grid's threads) instead of the per-warp queue;
//   the stacks in local memory, as kept;
// - design 1, "smem_stack": the per-warp queue, as kept, with each
//   thread's ring stack in shared memory after the table, one column per
//   thread (stack_depth * 4 * 512 more bytes per block).
// K3's stage each treelet slab on chip for the visits that share it, as
// the TPU kernel stages one slab in VMEM per grid block, with K3's per-slot
// code (treelet_visit): a persistent grid of 512-thread blocks, one per
// SM, walks chunks of the sorted slots (treelet_chunks) and stages the
// slab of each long enough treelet segment:
// - design 0, "cluster": the slab spread over a cluster of n = 1, 2, 4 or
//   8 blocks (utils/schedule_probe.slab_variant: 2 for 512-row slabs), row
//   i in block i % n, read through the cluster's distributed shared memory
//   (cluster_rows.cuh's ClusterStage);
// - design 1, "split": one block, no cluster, holds rows 0-452 of the slab
//   (453 x 512 bytes and the walk's two words fill the 227 KB a block may
//   hold) and reads rows 453-511 from device memory; every row through a
//   generic load (cluster_rows.cuh's SplitStage);
// - design 2, "walk": design 1's schedule with nothing staged and no
//   shared memory, every row from device memory (the schedule's own cost).
// Their chunk size, fewest visits of a staged segment and a stage-only
// switch are given at run time, so that one call can time other choices.
// K2's split variant (top tables past one block's shared memory:
// traversal_tt.cu's top_visits_split_kernel, rows 0-452 on chip, the rest
// through L1/L2) was measured against two designs here:
// - design 2, "cluster" (probe_top_cluster_kernel): the top table over the
//   shared memory of a cluster of n blocks (n from
//   utils/schedule_probe.slab_variant, and 2n), row i in block i % n, read
//   through the cluster's windows, rays from the same queue in the
//   stream's work area;
// - design 3, "global" (probe_top_global_kernel): one thread per ray, rows
//   through L1/L2, K2's first kernel.
// K1's global variant's group design (traverse8_group_kernel, 16 lanes a
// live ray) is measured against the same kernel with 8 or 32 lanes a ray,
// and with 16 lanes and an L2 prefetch of each node step's eligible
// children (L2Prefetch).
// K4 (traversal_pool.cu, one threshold of idle lanes before a warp claims
// rays, one bound on its fetches an iteration) is measured against the
// same kernel at thresholds 1, 8 and 16, with 1 or 2 fetches, and
// against its first design: a refill at every step, dead rays stepped, rows
// through L1/L2 on every table, a memset of the queue counter before each
// launch.
// All compute what the kept kernels compute, bit for bit.

#include "cluster_rows.cuh"
#include "traversal8.cu"
#include "traversal_pool.cu"
#include "traversal_tt.cu"

namespace {

using namespace ctl;

constexpr int kStride = 0;
constexpr int kSmemStack = 1;
constexpr int kTopCluster = 2;  // K2's cluster design
constexpr int kTopGlobal = 3;   // K2 with one thread per ray

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

// The group design's hint that asks L2 for the row an eligible child's
// link points to (a node: its boxes and links, 224 bytes; a leaf: its
// triangles, 480 bytes), so that a later step that descends there finds
// it on chip.
struct L2Prefetch {
  static __device__ __forceinline__ void child(const float* __restrict__ table,
                                               int n_rows, int link) {
    const int row = min(max(link >= 0 ? link : -2 - link, 0), n_rows - 1);
    const float* p = table + (size_t)row * 128;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + 32));
    if (link < 0) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p + 64));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(p + 96));
    }
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
                     const float* tmax, const int* roots,
                     const uint8_t* any_mask, int n_rays, int any_hit,
                     int stack_depth, int max_iters,
                     float* t_out, int* tri_out, float* u_out, float* v_out,
                     int* steps_out, uint8_t* flags_out, int* vid_out,
                     float* vent_out, int* vcnt_out, float* mdrop_out,
                     int* next_ray, cudaStream_t stream) {
  static SharedOptIn opt[2];
  auto kernel = design == kStride ? probe_top_visits_kernel<V, kStride>
                                  : probe_top_visits_kernel<V, kSmemStack>;
  return launch_design(kernel, opt[design], design, n_top, stack_depth,
                       n_rays, next_ray, stream, top, n_top, o, d, tmin, tmax,
                       roots, any_mask, n_rays, any_hit, stack_depth,
                       max_iters, t_out, tri_out, u_out, v_out, steps_out,
                       flags_out, vid_out, vent_out, vcnt_out, mdrop_out);
}

// ---- K3's designs ----------------------------------------------------------

constexpr int kCluster = 0;
constexpr int kSplit = 1;
constexpr int kWalk = 2;

// The cluster design's staged slab is cluster_rows.cuh's ClusterStage, the
// split design's its SplitStage (both given the slab as their table).

// The walk design's "staged" slab stays in device memory: the split
// design's schedule (one block per SM; chunks, segments, barriers) with no
// shared memory and no copy, to tell the schedule's cost from the
// staging's.
struct WalkStage : GlobalRows {
  static __device__ __forceinline__ void stage(const float4*, int, unsigned) {}
  static __device__ __forceinline__ const float4* table(const float4* slab) {
    return slab;
  }
};

// The word `w` of the cluster's first block (this block's own when kRanks
// is 1).
template <int kRanks>
__device__ __forceinline__ int* leader_word(int* w) {
  if constexpr (kRanks == 1) {
    return w;
  } else {
    return cooperative_groups::this_cluster().map_shared_rank(w, 0u);
  }
}

// The end of the run of treelet `tid` that starts at sorted slot lo, within
// [lo, hi): the first slot whose key names a later treelet (keys sorted).
__device__ __forceinline__ int segment_end(const int* __restrict__ keys,
                                           int lo, int hi, int tid) {
  int a = lo + 1, b = hi;
  while (a < b) {
    const int m = (a + b) >> 1;
    if ((keys[m] >> kVidRootBits) > tid) {
      b = m;
    } else {
      a = m + 1;
    }
  }
  return a;
}

// K3's slots on a persistent cluster of kRanks blocks, `Staged` being where
// a staged slab lives. The cluster takes chunks of `chunk` sorted slots
// from the queue counter queue[0] and walks each chunk's treelet segments
// (runs of one treelet id), finding their ends by binary search over the
// keys. A segment of at least `min_stage` visits is staged: each block
// copies its share of the slab into its shared memory, adds one to
// queue[1] (the staged segments), and after a cluster barrier the
// cluster's warps take the segment's slots from a counter in the first
// block's shared memory, reading rows on chip. A run of shorter segments,
// and the invalid slots sorted last, are taken the same way, their slabs
// read from device memory. A barrier closes each step, before any block
// overwrites its share or exits, so no block reads a share that its owner
// has moved on from. With stage_only the cluster stages and walks but
// traverses nothing. Every decision is the same in every thread, so the
// barriers are uniform. A visit whose treelet is not the staged one (keys
// out of order) reads device memory, so any order gives K3's result.
template <int kRanks, class Staged>
__device__ __forceinline__ void treelet_chunks(CTL_K3_PARAMS, int chunk,
                                               int min_stage, bool stage_only,
                                               int* queue) {
  __shared__ int s_chunk, s_next;
  const unsigned rank = cluster_rank<kRanks>();
  const bool leader = rank == 0 && threadIdx.x == 0;
  int stack[kMaxStack];
  if (leader) s_chunk = atomicAdd(queue, 1);
  cluster_sync<kRanks>();
  for (;;) {
    const int c = *static_cast<volatile int*>(leader_word<kRanks>(&s_chunk));
    if (c >= (n_visits + chunk - 1) / chunk) break;
    const int hi = min(n_visits, (c + 1) * chunk);
    for (int lo = c * chunk; lo < hi;) {
      const int tid = keys[lo] >> kVidRootBits;
      int end = segment_end(keys, lo, hi, tid);
      const bool staged = tid < n_treelets && end - lo >= min_stage;
      const float4* slab = slabs + (size_t)tid * rows * 32;
      if (staged) {
        Staged::stage(slab, rows, rank);
        if (leader) atomicAdd(queue + 1, 1);
      } else {
        while (end < hi) {  // the following short or invalid segments
          const int t2 = keys[end] >> kVidRootBits;
          const int e2 = segment_end(keys, end, hi, t2);
          if (t2 < n_treelets && e2 - end >= min_stage) break;
          end = e2;
        }
      }
      if (leader) s_next = lo;
      cluster_sync<kRanks>();
      // every thread has read this chunk's id: the leader claims the next
      if (leader && end == hi) s_chunk = atomicAdd(queue, 1);
      if (!stage_only) {
        const int staged_tid = staged ? tid : -1;
        bool drained = false;
        while (!drained) {  // warp-uniform
          const int i =
              warp_fetch(leader_word<kRanks>(&s_next), true, end, drained);
          if (i < 0) continue;
          if ((keys[i] >> kVidRootBits) == staged_tid) {
            treelet_visit<Staged>(CTL_K3_ARGS, Staged::table(slab), i, stack);
          } else {
            treelet_visit<GlobalRows>(
                CTL_K3_ARGS, visit_slab(slabs, rows, keys, i), i, stack);
          }
        }
      }
      cluster_sync<kRanks>();
      lo = end;
    }
  }
  cluster_sync<kRanks>();
}

template <int kRanks, class Staged>
__global__ void __launch_bounds__(kPersistThreads, 1)
probe_treelet_kernel(CTL_K3_PARAMS, int chunk, int min_stage, int stage_only,
                     int* queue) {
  treelet_chunks<kRanks, Staged>(CTL_K3_ARGS, chunk, min_stage,
                                 stage_only != 0, queue);
}

// Zeroes queue[0..1] on the stream and launches `kernel` as a persistent
// grid of clusters of `ranks` blocks of kPersistThreads threads with
// `bytes` of dynamic shared memory each (launch_clusters): as many clusters
// as fit on the card at once, no more than n_chunks.
template <class... Params, class... Args>
int launch_cluster(void (*kernel)(Params...), ClusterOptIn& opt, int ranks,
                   size_t bytes, int n_chunks, int* queue,
                   cudaStream_t stream, Args... args) {
  cudaMemsetAsync(queue, 0, 2 * sizeof(int), stream);
  return launch_clusters(kernel, opt, ranks, kPersistThreads, bytes, n_chunks,
                         stream, args..., queue);
}

// ---- K2's cluster design ----------------------------------------------------

// K2's split variant (traversal_tt.cu) with the cluster design's row
// source: the top table over the shared memory of a cluster of kRanks
// blocks (ClusterStage), read through the cluster's windows.
template <int V, int kRanks>
__global__ void __launch_bounds__(kPersistThreads, 1)
probe_top_cluster_kernel(CTL_K2_PARAMS, int* __restrict__ work,
                         int* __restrict__ next) {
  top_staged<V, ClusterStage<kRanks>, kRanks>(CTL_K2_FORWARD, work, next);
}

// Launches the cluster design as a persistent grid of clusters of kRanks
// blocks, as many as can be resident at once (none: refused), no more than
// the rays need, counting in set `set` of the work area `work`.
template <int V, int kRanks>
int launch_top_cluster(CTL_K2_PARAMS, int* work, int set,
                       cudaStream_t stream) {
  static ClusterOptIn opt;
  const int blocks = (n_rays + kPersistThreads - 1) / kPersistThreads;
  return launch_clusters(probe_top_cluster_kernel<V, kRanks>, opt, kRanks,
                         kPersistThreads, ClusterStage<kRanks>::bytes(n_top),
                         (blocks + kRanks - 1) / kRanks, stream,
                         CTL_K2_FORWARD, work + kSet * set,
                         work + kSet * (1 - set));
}

// K2 with one thread per ray, top rows from device memory.
template <int V>
__global__ void __launch_bounds__(kThreads)
probe_top_global_kernel(CTL_K2_PARAMS) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  int stack[kMaxStack];
  top_ray<V, GlobalRows>(CTL_K2_ARGS(top), i, stack);
}

template <int V>
int launch_top_global(CTL_K2_PARAMS, cudaStream_t stream) {
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  probe_top_global_kernel<V><<<blocks, kThreads, 0, stream>>>(CTL_K2_FORWARD);
  return (int)cudaGetLastError();
}

template <int V>
int launch_top_cluster_n(int ranks, CTL_K2_PARAMS, int* work, int set,
                         cudaStream_t stream) {
  auto launch = ranks == 1   ? launch_top_cluster<V, 1>
                : ranks == 2 ? launch_top_cluster<V, 2>
                : ranks == 4 ? launch_top_cluster<V, 4>
                             : launch_top_cluster<V, 8>;
  return launch(CTL_K2_FORWARD, work, set, stream);
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

// ctl_traverse8's arguments for K1's global variant in the group design,
// with `design` in place of the variant: 0, 8 lanes a live ray; 1, 32
// lanes; 2, 16 lanes (as kept) and L2Prefetch. work: the design's work
// area (warp_queue.cuh; kWork + n_rays int32), counting in its set `set`.
// Returns a CUDA error code, or -1 for another design or set.
extern "C" int ctl_probe_traverse8_group(
    const float* table, int n_rows, const float* o, const float* d,
    const float* tmin, const float* tmax, const int* roots,
    const uint8_t* any_mask, int n_rays, int any_hit, int stack_depth,
    int max_iters, float* t_out, int* tri_out, float* u_out, float* v_out,
    int* steps_out, uint8_t* flags_out, int* work, int set, int design,
    void* stream) {
  if (design < 0 || design > 2 || set < 0 || set > 1) return -1;
  if (n_rays <= 0) return (int)cudaGetLastError();
  auto launch = design == 0   ? launch_group<8>
                : design == 1 ? launch_group<32>
                              : launch_group<16, L2Prefetch>;
  return launch(reinterpret_cast<const float4*>(table), n_rows, o, d, tmin,
                tmax, roots, any_mask, n_rays, any_hit, stack_depth,
                max_iters, t_out, tri_out, u_out, v_out, steps_out,
                flags_out, work, set, (cudaStream_t)stream);
}

// ctl_traverse_pool's arguments, with `design` after the variant: 1, 8 or
// 16, K4 with that threshold of idle lanes (kFetchRounds fetches); 101 or
// 102, K4's threshold with 1 or 2 fetches an iteration; 0, K4's first
// design (the threshold 1, dead rays stepped, rows from device memory
// whatever the variant, and a memset of the set's queue counter before
// the launch, as the first design zeroed its counter). Returns a CUDA
// error code, or -1 for another design, variant or set.
extern "C" int ctl_probe_traverse_pool(
    const float* table, int n_rows, const float* o, const float* d,
    const float* tmin, const float* tmax, const int* roots,
    const uint8_t* any_mask, int n_rays, int any_hit, int stack_depth,
    int max_iters, float* t_out, int* tri_out, float* u_out, float* v_out,
    int* steps_out, uint8_t* flags_out, int* work, int set, int variant,
    int design, void* stream) {
  if (variant < 0 || variant > 1 || set < 0 || set > 1) return -1;
  if (design != 0 && design != 1 && design != 8 && design != 16 &&
      design != 101 && design != 102) {
    return -1;
  }
  if (n_rays <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 0) {
    cudaMemsetAsync(work + kSet * set + kInput, 0, sizeof(int), s);
    variant = 0;
  }
  auto launch = design == 0     ? launch_pool<1, 1, kStepDead>
                : design == 1   ? launch_pool<1>
                : design == 8   ? launch_pool<8>
                : design == 16  ? launch_pool<16>
                : design == 101 ? launch_pool<kFetchIdle, 1>
                                : launch_pool<kFetchIdle, 2>;
  return launch(variant, reinterpret_cast<const float4*>(table), n_rows, o, d,
                tmin, tmax, roots, any_mask, n_rays, any_hit, stack_depth,
                max_iters, t_out, tri_out, u_out, v_out, steps_out,
                flags_out, work, set, s);
}

// ctl_top_visits's arguments, with `design` in place of the variant and
// `ranks` after it: design 0 stride, 1 smem_stack (the shared variant's
// designs; scratch: the queue counter, zeroed here), 2 cluster over
// `ranks` blocks (1, 2, 4 or 8; scratch: the work area, counting in its
// set `set`, as the split variant's), 3 global (one thread per ray;
// scratch unused). Returns a CUDA error code (a cluster of which none can
// be resident is refused), or -1 for another V, design, ranks count or
// set.
extern "C" int ctl_probe_top_visits(
    const float* top, int n_top, const float* o, const float* d,
    const float* tmin, const float* tmax, const int* roots,
    const uint8_t* any_mask, int n_rays, int any_hit, int V, int stack_depth,
    int max_iters, float* t_out, int* tri_out, float* u_out, float* v_out,
    int* steps_out, uint8_t* flags_out, int* vid_out, float* vent_out,
    int* vcnt_out, float* mdrop_out, int* scratch, int design, int ranks,
    int set, void* stream) {
  if ((V != 3 && V != 6) || design < kStride || design > kTopGlobal ||
      set < 0 || set > 1) {
    return -1;
  }
  if (design == kTopCluster && ranks != 1 && ranks != 2 && ranks != 4 &&
      ranks != 8) {
    return -1;
  }
  if (n_rays <= 0) return (int)cudaGetLastError();
  const float4* t4 = reinterpret_cast<const float4*>(top);
  cudaStream_t s = (cudaStream_t)stream;
  if (design == kTopGlobal) {
    auto launch = V == 3 ? launch_top_global<3> : launch_top_global<6>;
    return launch(t4, n_top, o, d, tmin, tmax, roots, any_mask, n_rays,
                  any_hit, stack_depth, max_iters, t_out, tri_out, u_out,
                  v_out, steps_out, flags_out, vid_out, vent_out, vcnt_out,
                  mdrop_out, s);
  }
  if (design == kTopCluster) {
    auto launch = V == 3 ? launch_top_cluster_n<3> : launch_top_cluster_n<6>;
    return launch(ranks, t4, n_top, o, d, tmin, tmax, roots, any_mask, n_rays,
                  any_hit, stack_depth, max_iters, t_out, tri_out, u_out,
                  v_out, steps_out, flags_out, vid_out, vent_out, vcnt_out,
                  mdrop_out, scratch, set, s);
  }
  auto launch = V == 3 ? launch_probe_top<3> : launch_probe_top<6>;
  return launch(design, t4, n_top, o, d, tmin, tmax, roots, any_mask, n_rays,
                any_hit, stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                steps_out, flags_out, vid_out, vent_out, vcnt_out, mdrop_out,
                scratch, s);
}

// ctl_treelet_hits's arguments, then queue (an int32[2] of the caller's:
// the chunk queue's counter and, after the launch, the count of staged
// segments; zeroed here on the stream), `design` (0 cluster, 1 split,
// 2 walk), the cluster design's blocks per cluster (1, 2, 4 or 8; the
// others take 1), the chunk size, the fewest visits of a staged segment
// and stage_only (stage and walk, traverse nothing: the outputs are not
// written). Returns a CUDA error code, or -1 for another design, blocks
// count or chunk < 1.
extern "C" int ctl_probe_treelet_hits(
    const float* slabs, int n_treelets, int rows, const float* o,
    const float* d, const float* tmin, const float* t_prune,
    const uint8_t* any_mask, int any_hit, const int* keys, const int* order,
    int n_visits, int V, int stack_depth, int max_iters, float* t_out,
    int* tri_out, float* u_out, float* v_out, int* steps_out,
    uint8_t* flags_out, int* queue, int design, int ranks, int chunk,
    int min_stage, int stage_only, void* stream) {
  if (design < kCluster || design > kWalk || chunk < 1) return -1;
  if (design != kCluster) ranks = 1;
  if (ranks != 1 && ranks != 2 && ranks != 4 && ranks != 8) return -1;
  if (n_visits <= 0) return (int)cudaGetLastError();
  static ClusterOptIn opt[6];
  using Kernel = void (*)(const float4*, int, int, const float*, const float*,
                          const float*, const float*, const uint8_t*, int,
                          const int*, const int*, int, int, int, int, float*,
                          int*, float*, float*, int*, uint8_t*, int, int, int,
                          int*);
  Kernel kernel = probe_treelet_kernel<1, WalkStage>;
  int slot = 5;
  size_t bytes = 0;
  if (design == kSplit) {
    kernel = probe_treelet_kernel<1, SplitStage>;
    slot = 4;
    bytes = (size_t)(rows < kSplitRows ? rows : kSplitRows) * 512;
  } else if (design == kCluster) {
    const Kernel by_ranks[4] = {probe_treelet_kernel<1, ClusterStage<1>>,
                                probe_treelet_kernel<2, ClusterStage<2>>,
                                probe_treelet_kernel<4, ClusterStage<4>>,
                                probe_treelet_kernel<8, ClusterStage<8>>};
    slot = ranks == 1 ? 0 : ranks == 2 ? 1 : ranks == 4 ? 2 : 3;
    kernel = by_ranks[slot];
    bytes = (size_t)((rows + ranks - 1) / ranks) * 512;
  }
  return launch_cluster(kernel, opt[slot], ranks, bytes,
                        (n_visits + chunk - 1) / chunk, queue,
                        (cudaStream_t)stream,
                        reinterpret_cast<const float4*>(slabs), n_treelets,
                        rows, o, d, tmin, t_prune, any_mask, any_hit, keys,
                        order, n_visits, V, stack_depth, max_iters, t_out,
                        tri_out, u_out, v_out, steps_out, flags_out, chunk,
                        min_stage, stage_only);
}
