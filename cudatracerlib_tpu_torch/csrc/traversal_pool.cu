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
// What it attacks, as the TPU kernel does: K1 hands each warp 32 rays and
// the warp holds them until the slowest is done, so its finished lanes
// idle. The lane-utilization count (with_util: the rays' steps over 32
// lane slots a warp iteration) says how much: on veach-mis bounce rays K1
// issues ~3.3x the slots the steps need (ops/traversal8.py::static_slots).
// Here a lane that finishes a ray takes the next unstarted ray of the whole
// batch between two steps: the persistent threads with dynamic fetch of
// the original library (Kernel/TraceHelper.cu:379-427), not the TPU
// kernel's pool of K*128 rays, lane prefix sum, one-hot scatter and host
// un-permute. The design:
// - rows from the row source the table's size allows (bvh8_traverse.cuh),
//   as K1 and K2: a table that fits a block's shared memory
//   (ops/traversal8.launch_variant) is staged by each of one 512-thread
//   block per SM and read with LDS.128 (SharedRows); a larger one is read
//   from device memory through L1/L2 with LDG (GlobalRows) by a persistent
//   grid of 128-thread blocks;
// - refill with a threshold: a warp claims rays (warp_queue.cuh: a
//   ballot, one atomicAdd a warp, a shuffle) only when at least F of its
//   lanes are idle (kFetchIdle; F = 1 refills at every step);
// - dead lanes take no step slot: a fetched ray with !(tmin <= tmax), a
//   node-row start and max_iters >= 1 (ops/traversal8.live_lanes) has its
//   fixed outputs written without a row read (t = tmax, tri -1, u = v = 0,
//   one step, no flag), and the lane fetches again in the same iteration,
//   up to R fetches (kFetchRounds), so that a warp cannot spin on a run
//   of dead rays;
// - no memset and no allocation a launch: the queue counter lives in the
//   caller's work area for the stream (warp_queue.cuh), whose two counter
//   sets launches take in turn, each zeroing the other;
// - each ray runs bvh8_traverse.cuh's Walk::init and step on the same
//   state, ring stack and cap as in K1: only which lane runs which ray,
//   when, and where its rows come from change, never the visit order, so
//   steps, the overflow flag and the lowest-index ties stay K1's.
// Each warp counts 32 lane slots for each iteration of its loop that steps
// a lane or writes a dead ray, and the lane steps run in them (a dead ray
// its one step), and adds both to the work area when it leaves, so the
// lane steps equal the sum of the rays' steps.
//
// What bounds it on this card, as K1: the instruction stream under
// divergence (a lane runs a node step's 8 slab tests or a leaf step's 12
// triangle tests in series, and a warp runs its node-step and leaf-step
// lanes one after the other) and the latency of dependent row loads, not
// device-memory bandwidth. csrc/schedule_probe.cu keeps the thresholds not
// taken and K4's first design (F = 1, dead rays stepped, rows through
// L1/L2, a memset a launch) for the comparison in chip_smoke.py
// (PERF.md).

#include "bvh8_traverse.cuh"
#include "warp_queue.cuh"

namespace {

using namespace ctl;

// (kFetchIdle, the idle lanes a warp waits for before it claims rays, and
// kFetchRounds, the fetches a lane makes in one warp iteration while it
// draws dead rays, are in warp_queue.cuh)
// the probe's first design (csrc/schedule_probe.cu): every ray stepped
constexpr bool kStepDead = false;

// One warp's share of the launch: rays from the queue in the counter set
// `work` (warp_queue.cuh) until it is drained and the warp's lanes are
// done, rows from `table` through the row source Rows (for SharedRows the
// block's staged copy). F: idle lanes before a claim; R: fetches an
// iteration while a lane draws dead rays; kSkipDead: write dead rays at
// fetch (false: step them, as K4's first design does).
template <class Rows, int F, int R, bool kSkipDead>
__device__ __forceinline__ void pool_loop(CTL_K1_PARAMS,
                                          int* __restrict__ work) {
  int ray = -1;  // the lane's ray, -1 while it has none
  int cur = kDone, steps = 0;
  uint8_t flags = 0;
  bool anyh = false;
  Ray r{};
  Best b{};
  int stack[kMaxStack];
  Walk w;
  w.init();
  NoVisit none;
  bool drained = false;
  long long slots = 0, active = 0;  // warp-uniform
  int live = 0, taken = 0;          // this lane's rays
  for (;;) {  // warp-uniform: every lane reaches each ballot and fetch
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
    if (!drained && __popc(__ballot_sync(kFullMask, ray < 0)) >= F) {
      for (int round = 0; round < R; ++round) {
        const int id = warp_fetch(work + kInput, ray < 0, n_rays, drained);
        bool dead = false;
        if (id >= 0) {
          ++taken;
          const float tn = tmin[id], tx = tmax[id];
          const int start = ((roots != nullptr ? roots[id] : 0) << 8) | 0xFF;
          dead = kSkipDead && !(tn <= tx) && start >= 0 && max_iters >= 1;
          if (dead) {
            t_out[id] = tx;
            tri_out[id] = -1;
            u_out[id] = 0.0f;
            v_out[id] = 0.0f;
            steps_out[id] = 1;
            flags_out[id] = 0;
          } else {
            ++live;
            ray = id;
            r = load_ray(o, d, tmin, id);
            anyh = any_hit || (any_mask != nullptr && any_mask[id] != 0);
            b = Best{tx, -1, 0.0f, 0.0f};
            cur = start;
            steps = 0;
            flags = 0;
            w.init();
          }
        }
        const unsigned dm = __ballot_sync(kFullMask, dead);
        if (dm == 0u) break;
        slots += 32;
        active += __popc(dm);
      }
    }
    const bool run = ray >= 0 && steps < max_iters;
    const unsigned rm = __ballot_sync(kFullMask, run);
    if (rm == 0u) {
      if (drained && !__any_sync(kFullMask, ray >= 0)) break;
      continue;  // an idle warp fetches again; a capped ray retires
    }
    slots += 32;
    active += __popc(rm);
    if (run) {
      ++steps;
      cur = step<Rows>(table, n_rows, kNoVirtual, r, cur, anyh, stack_depth,
                       stack, w, b, flags, none);
    }
  }
  add_counts(work, live, taken, slots, active);
}

// Rows from device memory: a persistent grid of kThreads-thread blocks.
// work: this launch's counter set (zero); next: the other, zeroed here.
template <int F, int R, bool kSkipDead>
__global__ void __launch_bounds__(kThreads)
traverse_pool_kernel(CTL_K1_PARAMS, int* __restrict__ work,
                     int* __restrict__ next) {
  zero_set(next);
  pool_loop<GlobalRows, F, R, kSkipDead>(
      table, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
      stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
      flags_out, work);
}

// Rows from the block's copy of the table: one kPersistThreads-thread
// block per SM stages it (stage_rows), then its warps drain the queue.
template <int F, int R>
__global__ void __launch_bounds__(kPersistThreads, 1)
traverse_pool_shared_kernel(CTL_K1_PARAMS, int* __restrict__ work,
                            int* __restrict__ next) {
  extern __shared__ float4 smem[];
  zero_set(next);
  stage_rows(smem, table, n_rows);
  pool_loop<SharedRows, F, R, true>(
      smem, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
      stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
      flags_out, work);
}

// Launches K4 with threshold F, R fetch rounds (and kSkipDead, global
// rows only) on
// `variant`'s grid (0: the persistent grid of traverse_pool_kernel, kept
// for each device; 1: one shared-table block per SM, no more blocks than
// the rays need), counting in set `set` of `work`, which must be zero.
// Returns the first CUDA error (a table over the card's shared memory is
// refused).
template <int F, int R = kFetchRounds, bool kSkipDead = true>
int launch_pool(int variant, const float4* table, int n_rows, const float* o,
                const float* d, const float* tmin, const float* tmax,
                const int* roots, const uint8_t* any_mask, int n_rays,
                int any_hit, int stack_depth, int max_iters, float* t_out,
                int* tri_out, float* u_out, float* v_out, int* steps_out,
                uint8_t* flags_out, int* work, int set, cudaStream_t s) {
  int* counts = work + kSet * set;
  int* next = work + kSet * (1 - set);
  if (variant == 1) {
    static SharedOptIn opt;
    const size_t bytes = (size_t)n_rows * 512;
    int blocks = 0;
    const int err = shared_grid(traverse_pool_shared_kernel<F, R>, opt,
                                kPersistThreads, bytes, n_rays, &blocks);
    if (err != 0) return err;
    traverse_pool_shared_kernel<F, R><<<blocks, kPersistThreads, bytes, s>>>(
        table, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
        stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
        flags_out, counts, next);
    return (int)cudaGetLastError();
  }
  static int grid[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, traverse_pool_kernel<F, R, kSkipDead>, kThreads, 0);
    grid[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int need = (n_rays + kThreads - 1) / kThreads;
  traverse_pool_kernel<F, R, kSkipDead>
      <<<need < grid[dev] ? need : grid[dev], kThreads, 0, s>>>(
      table, n_rows, o, d, tmin, tmax, roots, any_mask, n_rays, any_hit,
      stack_depth, max_iters, t_out, tri_out, u_out, v_out, steps_out,
      flags_out, counts, next);
  return (int)cudaGetLastError();
}

}  // namespace

// ctl_traverse8's arguments; work: the caller's work area for the stream
// (warp_queue.cuh; at least kWork int32), counting in its set `set` (0 or
// 1, zero); variant: 0 rows from device memory, 1 the table staged in
// shared memory. Returns a CUDA error code, or -1 for another variant or
// set.
extern "C" int ctl_traverse_pool(const float* table, int n_rows,
                                 const float* o, const float* d,
                                 const float* tmin, const float* tmax,
                                 const int* roots, const uint8_t* any_mask,
                                 int n_rays, int any_hit, int stack_depth,
                                 int max_iters, float* t_out, int* tri_out,
                                 float* u_out, float* v_out, int* steps_out,
                                 uint8_t* flags_out, int* work, int set,
                                 int variant, void* stream) {
  if (variant < 0 || variant > 1 || set < 0 || set > 1) return -1;
  if (n_rays <= 0) return (int)cudaGetLastError();
  return launch_pool<kFetchIdle>(
      variant, reinterpret_cast<const float4*>(table), n_rows, o, d, tmin,
      tmax, roots, any_mask, n_rays, any_hit, stack_depth, max_iters, t_out,
      tri_out, u_out, v_out, steps_out, flags_out, work, set,
      (cudaStream_t)stream);
}

// The threshold of idle lanes (kFetchIdle) and the fetch rounds
// (kFetchRounds) K4 keeps, in out[0] and out[1].
extern "C" void ctl_pool_schedule(int* out) {
  out[0] = kFetchIdle;
  out[1] = kFetchRounds;
}
