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
// against the card's opt-in shared memory per block (227 KB, 454 fat rows
// on an H100):
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
// - global, for a larger table: rows from device memory through L1/L2
//   (LDG), no size cap, in one of two designs that the caller picks
//   (`_design`; never from a read of the device):
//   - thread (traverse8_kernel): one thread per ray in 128-thread blocks.
//     Dense flat tables of 455 to 2,048 rows (cornell.xml's 612) and the
//     instanced visits' fallback (per-lane roots; 0-3 live lanes a batch)
//     run it.
//   - group (traverse8_group_kernel): the flat treelet path's exactness
//     fallback runs it on the 211,592-row San Miguel table, a batch whose
//     lanes have tmax -1 but for the few whose visits overflowed. A
//     persistent grid first writes every dead lane's outputs without
//     reading the table and compacts the live rays into a queue (ballot,
//     one atomicAdd a warp, shuffle), then a group of kGroupLanes lanes
//     takes each live ray from the queue and runs it to its end, the group
//     sharing each step's row: a node step tests one child a lane, a leaf
//     step one triangle a lane, and a shuffle reduction picks what the
//     serial scan picks.
//
// What bounds them on this card (H100 80GB HBM3, 700.00 W; PERF.md):
// - the fallback: the chain of its slowest live ray, one dependent row
//   fetch a step from a table twice the L2. The per-thread design took
//   0.8-3.0x the chain floor (the largest live steps times P1's 1.3 us a
//   dependent row): 0.28 ms for a 262,144-lane batch with 13,236 live
//   rays of up to 129 steps, most of it one thread issuing a node's 14 or
//   a leaf's 30 LDG.128 and 8 slab or 12 Moller-Trumbore tests one after
//   the other. The group design takes 0.12 ms there (0.093 against 0.14
//   at 985 live rays, 0.12-0.13 against 0.30 on 1,048,576 camera lanes,
//   4.0 against 8.1 ms over the 48 fallback calls of a San Miguel PT
//   pass): its step is a few coalesced loads, one test a lane and 3-4
//   shuffle rounds, and the dead lanes cost a read of tmin and tmax.
//   Where no lane is live it costs 1-4 us more a launch than the
//   per-thread design (classify, wait, drain). 16 lanes a ray beat 8 and
//   32, and an L2 prefetch of each node step's eligible children did not
//   pay (csrc/schedule_probe.cu).
// - dense tables: the instruction stream under divergence. A warp runs its
//   node-step lanes and its leaf-step lanes one after the other and waits
//   for its slowest ray; with a Cornell-class table in L1 the global and
//   shared variants take about the same time. There the group design
//   loses (16 lanes of which 8-12 work: 0.175 against 0.063 ms on 131,585
//   Cornell rays), so dense tables keep one thread per ray.
// Neither is near its bytes bound.
//
// The per-ray state machine (bvh8_traverse.cuh) is shared with K2, K3 and
// K4; the group design runs the same steps with the same float expressions
// in the same order, so every design agrees with the plain PyTorch version
// ops/traversal8.py::intersect_wide bit for bit.
//
// A launch goes on the caller's stream and allocates nothing; the shared
// variant's queue counter is the caller's int32 scratch, zeroed on the
// stream before the launch, and the group design's work area is the
// caller's, kept for the stream, whose two counter sets launches take in
// turn, each zeroing the other.

#include "bvh8_traverse.cuh"

namespace {

using namespace ctl;

// The group design's work area is warp_queue.cuh's: two counter sets that
// launches on a stream take in turn, then one live queue slot per ray.
// rays a warp claims at a time to classify, kChunk / 32 a lane
constexpr int kChunk = 256;
// lanes a live ray of the group design (csrc/schedule_probe.cu times 8 and
// 32)
constexpr int kGroupLanes = 16;

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


// ---- the global variant's group design ------------------------------------

// A lane's child (node step) or triangle (leaf step) test, the expressions
// of step() in bvh8_traverse.cuh in the same order.
__device__ __forceinline__ void child_test(const float* __restrict__ row,
                                           int j, const Ray& r, float bt,
                                           float& tn, float& tf, int& link) {
  const float lx = row[j], ly = row[8 + j], lz = row[16 + j];
  const float hx = row[24 + j], hy = row[32 + j], hz = row[40 + j];
  link = __float_as_int(row[48 + j]);
  const float t0x = (lx - r.ox) * r.ix, t1x = (hx - r.ox) * r.ix;
  const float t0y = (ly - r.oy) * r.iy, t1y = (hy - r.oy) * r.iy;
  const float t0z = (lz - r.oz) * r.iz, t1z = (hz - r.oz) * r.iz;
  tn = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)), maxp(minp(t0z, t1z), r.tmn));
  tf = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)), minp(maxp(t0z, t1z), bt));
}

__device__ __forceinline__ bool tri_test(const float* __restrict__ row, int m,
                                         const Ray& r, float bt, float& t,
                                         float& u, float& v, int& id) {
  const float v0x = row[m], v0y = row[12 + m], v0z = row[24 + m];
  const float e1x = row[36 + m], e1y = row[48 + m], e1z = row[60 + m];
  const float e2x = row[72 + m], e2y = row[84 + m], e2z = row[96 + m];
  id = __float_as_int(row[108 + m]);
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return id != -1 && fabsf(det) >= 1e-12f && u >= 0.0f && v >= 0.0f &&
         u + v <= 1.0f && t > r.tmn && t < bt;
}

// The smaller of two (t, index) keys: t first, then the lower index, which
// is the candidate a serial scan with a strict < over ascending indices
// keeps (no candidate's t is NaN).
__device__ __forceinline__ void key_min(float& t, int& k, float ot, int ok) {
  if (ot < t || (ot == t && ok < k)) {
    t = ot;
    k = ok;
  }
}

// What a node step does with each eligible child's link besides taking or
// stacking it: nothing here (csrc/schedule_probe.cu times an L2 prefetch).
struct NoHint {
  static __device__ __forceinline__ void child(const float*, int, int) {}
};

// The (t, index) key least over the lanes `span` apart and closer within
// a group of G lanes (span a power of two, below G).
template <int G>
__device__ __forceinline__ void group_key_min(unsigned gmask, int span,
                                              float& t, int& k) {
#pragma unroll
  for (int off = span; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(gmask, t, off, G);
    const int ok = __shfl_xor_sync(gmask, k, off, G);
    key_min(t, k, ot, ok);
  }
}

// One live ray from `cur` to its end on a group of G lanes (8, 16 or 32 of
// one warp, `gmask` its lanes, `gl` this lane's index in it): step() and
// traverse() of bvh8_traverse.cuh, each step's row shared by the group.
// - node step: lane gl tests child gl & 7 (lanes 8 and up repeat lanes
//   0-7), and the group takes the least (tn, child) key among the eligible
//   children with tn < inf, as step()'s strict-< scan does; Hint::child
//   sees each eligible child's link;
// - leaf step: lane gl tests triangles gl % kTri, gl % kTri + kTri, ...
//   below 12 (kTri = min(G, 16): lanes 16 and up repeat lanes 0-15), and
//   the group takes the least (t, triangle) key, step()'s scan again;
// - the ring stack is spread over the group: entry p in lane p % G, slot
//   p / G of its registers; every lane keeps the top, the fill, the step
//   count, the flags and the best hit, all equal across the group.
// Each lane reads only the words of its child or triangle, so a node
// step's 8 lanes read the 224 bytes of boxes and links in 7 coalesced
// loads, a leaf step's 12 the 480 bytes of triangles in 10.
template <int G, class Hint>
__device__ __forceinline__ void group_traverse(
    const float* __restrict__ table, int n_rows, const Ray& r, int cur,
    bool anyh, int stack_depth, int max_iters, unsigned gmask, int gl,
    Best& b, int& steps, uint8_t& flags) {
  constexpr int kSlots = kMaxStack / G;
  constexpr int kTri = G < 16 ? G : 16;
  const float kInf = __int_as_float(0x7f800000);
  int stk[kSlots] = {};
  int pos = 0, n = 0;
  while (cur != kDone) {
    if (steps >= max_iters) {
      flags |= 1;
      break;
    }
    ++steps;
    int row_idx = cur >= 0 ? (cur >> 8) : (-2 - cur);
    row_idx = min(max(row_idx, 0), n_rows - 1);
    const float* row = table + (size_t)row_idx * 128;
    int nxt = kPop;
    if (cur >= 0) {
      const int j = gl & 7;
      float tn, tf;
      int link;
      child_test(row, j, r, b.t, tn, tf, link);
      const bool elig = (tn <= tf) && link != kDone && ((cur >> j) & 1);
      if (elig && gl < 8) Hint::child(table, n_rows, link);
      const unsigned eb = __ballot_sync(gmask, elig);
      float best_t = elig && tn < kInf ? tn : kInf;
      int best_j = elig && tn < kInf ? j : 8;
      group_key_min<G>(gmask, 4, best_t, best_j);
      const int link_best = __shfl_sync(gmask, link, best_j & 7, G);
      if (best_t < kInf) {
        nxt = link_best >= 0 ? ((link_best << 8) | 0xFF) : link_best;
        const int base = (threadIdx.x & 31) & ~(G - 1);
        const int elig_bits = (int)((eb >> base) & 0xFFu);
        const int remaining = elig_bits & ~(1 << best_j);
        if (remaining != 0) {
          pos = pos + 1 == stack_depth ? 0 : pos + 1;
          if (gl == pos % G) {
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              if (s == pos / G) stk[s] = (cur & ~0xFF) | remaining;
            }
          }
          if (n == stack_depth) {
            flags |= 2;
          } else {
            ++n;
          }
        }
      }
    } else {
      float hit_t = kInf, hu = 0.0f, hv = 0.0f;
      int hit_m = 16, hid = -1;
      for (int m = gl % kTri; m < 12; m += kTri) {
        float t, u, v;
        int id;
        if (tri_test(row, m, r, b.t, t, u, v, id) && t < hit_t) {
          hit_t = t, hit_m = m, hu = u, hv = v, hid = id;
        }
      }
      float best_t = hit_t;
      int best_m = hit_m;
      group_key_min<G>(gmask, kTri / 2, best_t, best_m);
      const int src = best_m % kTri;
      hid = __shfl_sync(gmask, hid, src, G);
      hu = __shfl_sync(gmask, hu, src, G);
      hv = __shfl_sync(gmask, hv, src, G);
      if (best_t < kInf) {
        b.t = best_t;
        b.tri = hid;
        b.u = hu;
        b.v = hv;
        if (anyh) nxt = kDone;
      }
    }
    if (nxt == kPop) {
      if (n > 0) {
        int top = 0;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (s == pos / G) top = stk[s];
        }
        nxt = __shfl_sync(gmask, top, pos % G, G);
        pos = pos == 0 ? stack_depth - 1 : pos - 1;
        --n;
      } else {
        nxt = kDone;
      }
    }
    cur = nxt;
  }
}

// An int of the launch's work area read with acquire semantics at device
// scope, so that what its writer wrote before it is seen after it.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The global variant's group design: a persistent grid; work = this
// launch's counter set of the int32 work area (warp_queue.cuh, zeroed),
// queue = the area's n_rays queue slots.
// 1. Whole warps claim kChunk rays at a time from the input counter (a
//    warp that reads it past the end claims nothing) and classify them 32
//    at a time. A dead lane, !(tmin <= tmax) with a
//    node-row start and max_iters >= 1, would take one step that admits
//    no child (tn >= tmin > tmax >= tf, or a NaN) and pop an empty stack,
//    so its outputs are written here without a row read: t = tmax, tri -1,
//    u = v = 0, one step, no flag. The live rays go on the live queue (a
//    ballot, one atomicAdd a warp, a shuffle), and after each chunk the
//    warp counts the rays it classified, behind a fence.
// 2. One thread of each block waits until every ray is classified (the
//    block's one barrier pair of the launch), and then each group of G
//    lanes takes live rays from the queue, one atomicAdd on the head each,
//    and runs each to its end (group_traverse), writing its results by ray
//    id. A warp waits only for rays that running warps have claimed, so the
//    launch ends whatever the grid's residency.
// 3. Each warp adds its lane slots and lane steps to the set (add_counts).
// next: the other set, zeroed here for the next launch.
template <int G, class Hint>
__global__ void __launch_bounds__(kThreads)
traverse8_group_kernel(CTL_K1_PARAMS, int* __restrict__ work,
                       int* __restrict__ next, int* __restrict__ queue) {
  const int lane = threadIdx.x & 31;
  zero_set(next);
  // lane slots and lane steps (add_counts): a classifying pass of 32 rays
  // is one warp iteration whose dead rays each run their one step; the
  // group phase's steps run one a group a warp iteration, so its warp
  // iterations are the most steps any group of the warp ran
  long long slots = 0, active = 0;
  int group_steps = 0;
  for (;;) {  // warp-uniform
    int base = n_rays;
    if (lane == 0 && __ldcg(work + kInput) < n_rays) {
      base = atomicAdd(work + kInput, kChunk);
    }
    base = __shfl_sync(kFullMask, base, 0);
    if (base >= n_rays) break;
    // every load of the chunk first, then the writes: one round trip
    float tn[kChunk / 32], tx[kChunk / 32];
    int start[kChunk / 32];
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      const int i = base + 32 * k + lane;
      const bool in = i < n_rays;
      tn[k] = in ? tmin[i] : 0.0f;
      tx[k] = in ? tmax[i] : 0.0f;
      start[k] = ((in && roots != nullptr ? roots[i] : 0) << 8) | 0xFF;
    }
#pragma unroll
    for (int k = 0; k < kChunk / 32; ++k) {
      const int i = base + 32 * k + lane;
      const bool live =
          i < n_rays && (tn[k] <= tx[k] || max_iters < 1 || start[k] < 0);
      if (i < n_rays && !live) {
        t_out[i] = tx[k];
        tri_out[i] = -1;
        u_out[i] = 0.0f;
        v_out[i] = 0.0f;
        steps_out[i] = 1;
        flags_out[i] = 0;
      }
      const unsigned dead = __ballot_sync(kFullMask, i < n_rays && !live);
      if (dead != 0u) {
        slots += 32;
        active += __popc(dead);
      }
      const unsigned lv = __ballot_sync(kFullMask, live);
      if (lv != 0u) {
        int slot = 0;
        if (lane == 0) slot = atomicAdd(work + kTail, __popc(lv));
        slot = __shfl_sync(kFullMask, slot, 0);
        if (live) queue[slot + __popc(lv & ((1u << lane) - 1u))] = i;
      }
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicAdd(work + kClassified, min(kChunk, n_rays - base));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned ns = 128;
    while (load_acquire(work + kClassified) < n_rays) {
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __syncthreads();
  const int tail = load_acquire(work + kTail);
  const int gl = lane & (G - 1);
  const unsigned gmask =
      G == 32 ? kFullMask : (((1u << G) - 1u) << (lane & ~(G - 1)));
  for (;;) {  // group-uniform
    int ray = -1;
    if (gl == 0 && __ldcg(work + kHead) < tail) {
      const int slot = atomicAdd(work + kHead, 1);
      if (slot < tail) ray = __ldcg(queue + slot);
    }
    ray = __shfl_sync(gmask, ray, 0, G);
    if (ray < 0) break;
    const Ray r = load_ray(o, d, tmin, ray);
    const bool anyh = any_hit || (any_mask != nullptr && any_mask[ray] != 0);
    Best b{tmax[ray], -1, 0.0f, 0.0f};
    int steps = 0;
    uint8_t flags = 0;
    group_traverse<G, Hint>(
        reinterpret_cast<const float*>(table), n_rows, r,
        ((roots != nullptr ? roots[ray] : 0) << 8) | 0xFF, anyh, stack_depth,
        max_iters, gmask, gl, b, steps, flags);
    if (gl == 0) {
      t_out[ray] = b.t;
      tri_out[ray] = b.tri;
      u_out[ray] = b.u;
      v_out[ray] = b.v;
      steps_out[ray] = steps;
      flags_out[ray] = flags;
    }
    group_steps += steps;
  }
  const int warp_iters = __reduce_max_sync(kFullMask, group_steps);
  active += __reduce_add_sync(kFullMask, gl == 0 ? group_steps : 0);
  add_counts(work, 0, 0, slots + 32LL * warp_iters, active);
}

// Launches the group design with G lanes a ray (and Hint) on a persistent
// grid: as
// many 128-thread blocks as fit on every SM at once (kept for each
// device), no more than one thread a ray needs, counting in `work`'s
// counter set `set` (0 or 1), which must be zero.
template <int G, class Hint = NoHint>
int launch_group(const float4* table, int n_rows, const float* o,
                 const float* d, const float* tmin, const float* tmax,
                 const int* roots, const uint8_t* any_mask, int n_rays,
                 int any_hit, int stack_depth, int max_iters, float* t_out,
                 int* tri_out, float* u_out, float* v_out, int* steps_out,
                 uint8_t* flags_out, int* work, int set, cudaStream_t s) {
  static int grid[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, traverse8_group_kernel<G, Hint>, kThreads, 0);
    grid[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int need = (n_rays + kThreads - 1) / kThreads;
  traverse8_group_kernel<G, Hint>
      <<<need < grid[dev] ? need : grid[dev], kThreads, 0, s>>>(
      table, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
      stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
      flags_out, work + kSet * set, work + kSet * (1 - set), work + kWork);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 global, one thread per ray; 1 shared; 2 and 3 global, the
// group design counting in set 0 or 1 of its work area. scratch: the shared
// variant's queue counter (an int32, zeroed here on the stream), or the
// group design's work area (kWork + n_rays int32, the set's counters
// zero; unused by variant 0). Returns a CUDA error code, or -1 for another
// variant.
extern "C" int ctl_traverse8(const float* table, int n_rows, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, const int* roots,
                             const uint8_t* any_mask, int n_rays, int any_hit,
                             int stack_depth, int max_iters, float* t_out,
                             int* tri_out, float* u_out, float* v_out,
                             int* steps_out, uint8_t* flags_out, int* scratch,
                             int variant, void* stream) {
  if (variant < 0 || variant > 3) return -1;
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
  if (variant >= 2) {
    return launch_group<kGroupLanes>(
        t4, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
        stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
        flags_out, scratch, variant - 2, s);
  }
  static SharedOptIn opt;
  return launch_shared(traverse8_shared_kernel, opt, kPersistThreads,
                       (size_t)n_rows * 512, n_rays, scratch, s, t4, n_rows,
                       o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
                       stack_depth, max_iters, t_out, tri_out, u_out, v_out,
                       steps_out, flags_out);
}
