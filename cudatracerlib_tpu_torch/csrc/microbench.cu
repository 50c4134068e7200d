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
// On Hopper they ask what bounds K1-K4 and the port's gathers, and what no
// profiler on the card's machine can give:
//   P1 chase_rows: each chain runs S dependent steps; each step reads the
//      first W float4 of a 512-byte row (W = 32, the whole row, or 14, what
//      a traversal's node step reads: bvh8_traverse.cuh's boxes and links)
//      and derives the next row from them. It measures the latency of a
//      dependent row fetch in the ways the traversal kernels read rows
//      (ctl_chase_rows's modes):
//      - thread: one thread a chain reads the row as W float4 through
//        L1/L2 (K1's per-thread design, K2's per-thread design);
//      - shared: the same from the block's copy of the table in shared
//        memory (K1's and K2's shared variants; it stands in for the
//        one-hot matmul: both ask what a row costs from on-chip memory);
//      - group: G lanes a chain (16: K1's group design), lane g reading
//        float4 g, g + G, ... below W coalesced, the xor reduced with
//        shuffles;
//      - cluster: the table over a cluster of n blocks in ClusterStage's
//        layout (cluster_rows.cuh), one thread a chain reading through
//        distributed shared memory (K2's cluster design);
//      - bulk: one lane a chain copies the row's W float4 into its own
//        512 bytes of shared memory with cp.async.bulk and an mbarrier,
//        then reads them there (TMA's dependent fetch).
//      A chain takes `lanes` threads (1, G, or 32: one chain a warp, the
//      latency alone), the others idle; staged rows are swizzled (float4
//      k of local row i at k ^ (i & 31)) so that lanes reading different
//      rows spread over the banks.
//   P2 (a) gather_take: out = table.index_select(0, idx), rows of 12 float32
//      copied, as the port gathers (ops/hashgrid.gather_neighbors' photon
//      rows, ops/texture._take_rows' texel quads: 48-byte rows). Bound by
//      device memory: each output row is written once, and a sorted run of
//      rows is read once. Three designs (ctl_gather_take):
//      - thread: one thread an output row, its 3 float4 loaded and
//        stored (the layout K1 reads rows in);
//      - flat: one thread an output float4, so that a warp's stores are
//        512 consecutive bytes and its loads coalesce where the rows are
//        consecutive (a run of the hash grid's 16 rows is 768 bytes);
//      - bulk: TMA both ways. One warp a block, one block an SM; each lane
//        owns a tile of 128 output rows in shared memory (6 KB:
//        one neighbourhood query's 8 runs of 16 rows), issues one
//        cp.async.bulk per run of consecutive indices into it, completed
//        on its mbarrier, then one bulk store of the tile.
//      The index stream is read once into shared memory by the whole warp
//      (coalesced) before the lanes scan their tiles.
//   P2 (b) step_only: bvh8_traverse.cuh's step on one node row or one
//      leaf row that the kernel holds in registers (RegRows below: swizzle
//      0, so that every index is a compile-time constant once the loops
//      unroll), the ray changed after every step by the step's result.
//      It times a step's slab or triangle tests without a row read: the
//      part of a traversal step that P1's reads leave out (chip_smoke.py's
//      chain floors add it). Bound by the latency of the step's dependent
//      float chain (one warp an SM) or the SM's issue rate (full
//      occupancy).
//      loop_only: an empty dependent float loop, bound by instruction
//      latency (trivial_loop's question: what does a step cost by itself).
//   P3 queue_fetch: warps drain a queue of n items through warp_queue.cuh's
//      warp_fetch in the three forms the kernels use (ctl_queue_fetch):
//      - memset: the counter zeroed on the stream before the launch, every
//        asking lane claims (K1's and K2's shared variants);
//      - work area: the counter in the stream's work area (two counter
//        sets in turn, no memset; K4, K1's group design, K2's split
//        variant);
//      - threshold: K4's claim, taken only when kFetchIdle lanes are idle,
//        up to kFetchRounds fetches an iteration (warp_queue.cuh); each
//        fetch loads the item's tmin and tmax (what K4 reads at fetch),
//        writes a dead item (!(tmin <= tmax)) at once and holds a live
//        one for its own count of busy iterations (a recorded
//        traversal's steps).
//      Each item adds one to its count, so a count other than 1 is a queue
//      fault. Bound by the atomic on the one counter and its round trip.
//      The TPU probe's building blocks map onto warp_fetch's intrinsics:
//      the narrow lane gathers (k_gather16, k_gather8) onto __shfl_sync, the lane prefix-sum rank
//      onto __ballot_sync + __popc, and the one-hot build and the small
//      dot_general onto a direct store: Hopper needs no matrix-unit
//      scatter.
// P1's row value is the xor of its first 4W 32-bit words; after step s a chain goes to
// row ((that xor + s * 0x9E3779B9) mod 2^32) mod the row count: the row's
// words decide it (the load cannot be skipped), and the step term keeps a
// chain from closing into a short cycle of cached rows. Launches go on the
// caller's stream and allocate nothing.

#include "cluster_rows.cuh"
#include "warp_queue.cuh"

namespace {

using namespace ctl;

constexpr int kThreadsMb = 128;

__device__ __forceinline__ unsigned xor4(float4 q) {
  return __float_as_uint(q.x) ^ __float_as_uint(q.y) ^ __float_as_uint(q.z) ^
         __float_as_uint(q.w);
}

// The xor of a row's first kWords float4.
template <int kWords = 32>
__device__ __forceinline__ unsigned row_xor(const float4* __restrict__ row) {
  unsigned h = 0u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) h ^= xor4(row[k]);
  return h;
}

__device__ __forceinline__ int next_row(unsigned h, int s, int n_rows) {
  return (int)((h + (unsigned)s * 0x9E3779B9u) % (unsigned)n_rows);
}

// The mbarrier and bulk-copy (TMA) steps of the bulk modes; barriers and
// shared memory are given by their 32-bit shared-window addresses.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on the barrier, expecting `bytes` more of copies in this phase.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, counted on the barrier.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One bulk copy from shared memory to device memory, as a group of its own.
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Waits until this thread's bulk stores have written device memory.
__device__ __forceinline__ void bulk_stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// P1's modes, the C entry's codes
constexpr int kChaseThread = 0, kChaseShared = 1, kChaseGroup = 2;
constexpr int kChaseCluster = 3, kChaseBulk = 4;

// The chain thread t runs, or -1: chains take `lanes` threads each, the
// first of which runs it (a group mode's G lanes run it together).
__device__ __forceinline__ int chain_of(int t, int lanes, int n_chains) {
  const int c = t / lanes;
  return (t % lanes == 0 && c < n_chains) ? c : -1;
}

template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_kernel(const float4* __restrict__ table, int n_rows,
                  const int* __restrict__ idx0, int n_chains, int n_steps,
                  int lanes, int* __restrict__ out) {
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    idx = next_row(row_xor<kWords>(table + (size_t)idx * 32), s, n_rows);
  }
  out[c] = idx;
}

// One chain from a table staged on chip by the row source Rows (shared
// memory, or a cluster's).
template <class Rows, int kWords>
__device__ __forceinline__ int chase_staged(int idx, int n_steps,
                                            int n_rows) {
  for (int s = 0; s < n_steps; ++s) {
    const float4* row = Rows::row(nullptr, idx);
    const int sw = Rows::swizzle(idx);
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) h ^= xor4(row[k ^ sw]);
    idx = next_row(h, s, n_rows);
  }
  return idx;
}

template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_shared_kernel(const float4* __restrict__ table, int n_rows,
                         const int* __restrict__ idx0, int n_chains,
                         int n_steps, int lanes, int* __restrict__ out) {
  ClusterStage<1>::stage(table, n_rows, 0u);
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  out[c] = chase_staged<ClusterStage<1>, kWords>(idx0[c], n_steps, n_rows);
}

// G lanes a chain: lane g of the group reads float4 g, g + G, ... of the
// row's first kWords (each G float4 one coalesced access), and shuffles
// within the group xor the parts. Whole warps run the loop (the shuffles take every lane):
// a lane of no chain runs the last chain's and writes nothing.
template <int G, int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_group_kernel(const float4* __restrict__ table, int n_rows,
                        const int* __restrict__ idx0, int n_chains,
                        int n_steps, int lanes, int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t % lanes;
  const int c = min(t / lanes, n_chains - 1);
  const bool writes = g == 0 && t / lanes < n_chains;
  const int k0 = g % G;  // lanes past G repeat the group's loads
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    const float4* row = table + (size_t)idx * 32;
    unsigned h = 0u;
#pragma unroll
    for (int j = 0; j < 32 / G; ++j) {
      if (k0 + j * G < kWords) h ^= xor4(row[k0 + j * G]);
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
      h ^= __shfl_xor_sync(kFullMask, h, off);
    }
    idx = next_row(h, s, n_rows);
  }
  if (writes) out[c] = idx;
}

// The table over a cluster of kRanks blocks (ClusterStage): every block
// stages its share, the cluster meets, the threads run their chains (a
// grid-stride loop, so that any grid the card can hold at once runs them
// all), and the cluster meets again before any block leaves.
template <int kRanks, int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_cluster_kernel(const float4* __restrict__ table, int n_rows,
                          const int* __restrict__ idx0, int n_chains,
                          int n_steps, int lanes, int* __restrict__ out) {
  ClusterStage<kRanks>::stage(table, n_rows, cluster_rank<kRanks>());
  cluster_sync<kRanks>();
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n_chains * lanes;
       t += gridDim.x * blockDim.x) {
    const int c = chain_of(t, lanes, n_chains);
    if (c >= 0) {
      out[c] = chase_staged<ClusterStage<kRanks>, kWords>(idx0[c], n_steps,
                                                           n_rows);
    }
  }
  cluster_sync<kRanks>();
}

// One lane a chain: each step copies the row's first kWords float4 into
// the thread's own 512 bytes of shared memory with one cp.async.bulk (the
// copy engine, through L2), whose completion the thread's mbarrier counts
// in bytes, waits for the barrier's phase, and reads them there (swizzled
// by the lane: the whole row's float4 k at k ^ lane, a node step's 14
// rotated by the lane, so that the lanes spread over the banks). The next
// copy's address depends on every word read, so the reads are done before
// the copy that overwrites them is issued.
template <int kWords>
__global__ void __launch_bounds__(kThreadsMb)
chase_rows_bulk_kernel(const float4* __restrict__ table, int n_rows,
                       const int* __restrict__ idx0, int n_chains,
                       int n_steps, int lanes, int* __restrict__ out) {
  extern __shared__ float4 bulk_rows[];
  const int c = chain_of(blockIdx.x * blockDim.x + threadIdx.x, lanes,
                         n_chains);
  if (c < 0) return;
  float4* buf = bulk_rows + threadIdx.x * 32;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bulk_rows + blockDim.x * 32);
  const unsigned bar = (unsigned)__cvta_generic_to_shared(bars + threadIdx.x);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(buf);
  mbar_init(bar);
  constexpr unsigned kBytes = kWords * 16;
  const int sw = threadIdx.x & 31;
  unsigned phase = 0u;
  int idx = idx0[c];
  for (int s = 0; s < n_steps; ++s) {
    mbar_expect(bar, kBytes);
    bulk_load(dst, table + (size_t)idx * 32, kBytes, bar);
    mbar_wait(bar, phase);
    phase ^= 1u;
    unsigned h = 0u;
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      h ^= xor4(buf[kWords == 32 ? (k ^ sw) : (k + sw) % kWords]);
    }
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

// ---- P2 (a): out = table.index_select(0, idx), rows of kTakeQ float4 ----

// the row width, in float4: the port's gathers' 48-byte rows (the bulk
// design's tiles of 128 rows for 32 lanes fill most of one SM's shared
// memory at it)
constexpr int kTakeQ = 3;

// the designs, the C entry's codes
constexpr int kTakeThread = 0, kTakeFlat = 1, kTakeBulk = 2;
// the bulk design: output rows a lane's tile holds, and lanes (tiles) a
// block; one warp a block
constexpr int kTileRows = 128, kTileLanes = 32;
// index words a lane's tile keeps in shared memory: one more than it
// holds, so that lanes reading the same position of their tiles fall on
// different banks
constexpr int kTileStride = kTileRows + 1;

// One thread an output row.
__global__ void __launch_bounds__(kThreadsMb)
gather_take_thread_kernel(const float4* __restrict__ table,
                          const int* __restrict__ idx, long long n,
                          float4* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float4* src = table + (size_t)idx[i] * kTakeQ;
  float4 q[kTakeQ];
#pragma unroll
  for (int k = 0; k < kTakeQ; ++k) q[k] = src[k];
#pragma unroll
  for (int k = 0; k < kTakeQ; ++k) out[i * kTakeQ + k] = q[k];
}

// One thread an output float4: a warp stores 512 consecutive bytes.
__global__ void __launch_bounds__(kThreadsMb)
gather_take_flat_kernel(const float4* __restrict__ table,
                        const int* __restrict__ idx, long long n,
                        float4* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * kTakeQ) return;
  const long long i = t / kTakeQ;
  out[t] = table[(size_t)idx[i] * kTakeQ + (int)(t - i * kTakeQ)];
}

// TMA both ways: one warp a block; rounds of kTileLanes consecutive tiles of
// kTileRows output rows, a tile a lane. In each round the warp reads the
// round's indices into shared memory (coalesced 16-byte loads), then each
// lane, once its previous bulk store has read its tile, issues one
// cp.async.bulk for every run of consecutive indices in its tile (rows k
// and k + 1 of a run lie side by side in the table), waits for them on its
// mbarrier, and stores the tile with one bulk copy. The stores of a round
// overlap the next round's index reads and copies.
__global__ void __launch_bounds__(kTileLanes, 1)
gather_take_bulk_kernel(const float4* __restrict__ table,
                        const int* __restrict__ idx, long long n,
                        float4* __restrict__ out) {
  extern __shared__ float4 take_smem[];
  constexpr unsigned kRowBytes = kTakeQ * 16;
  const int lane = threadIdx.x;
  float4* tile = take_smem + (size_t)lane * kTileRows * kTakeQ;
  int* ids = reinterpret_cast<int*>(take_smem + (size_t)kTileLanes * kTileRows * kTakeQ);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ids + kTileLanes * kTileStride);
  const unsigned bar = (unsigned)__cvta_generic_to_shared(bars + lane);
  const unsigned dst = (unsigned)__cvta_generic_to_shared(tile);
  mbar_init(bar);
  unsigned phase = 0u;
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  for (long long first_tile = (long long)blockIdx.x * kTileLanes;
       first_tile < tiles; first_tile += (long long)gridDim.x * kTileLanes) {
    // the round's indices, kTileLanes * kTileRows from row first_tile *
    // kTileRows on (idx is 16-byte aligned; the ragged end one at a time)
    const long long base = first_tile * kTileRows;
    const long long left = n - base;
    __syncwarp();
    for (int k = lane; k < kTileLanes * kTileRows / 4; k += kTileLanes) {
      const int j = 4 * k;
      int v[4];
      if (j + 4 <= left) {
        const int4 q = reinterpret_cast<const int4*>(idx + base)[k];
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = j + c < left ? idx[base + j + c] : 0;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ids[((j + c) / kTileRows) * kTileStride + (j + c) % kTileRows] = v[c];
      }
    }
    __syncwarp();
    const long long t = first_tile + lane;
    if (t < tiles) {
      const long long row0 = t * kTileRows;
      const int rows = (int)min((long long)kTileRows, n - row0);
      const int* my = ids + lane * kTileStride;
      bulk_stores_read();   // the previous store has read the tile
      mbar_expect(bar, rows * kRowBytes);
      int start = 0, start_row = my[0];
      for (int k = 1; k <= rows; ++k) {
        if (k == rows || my[k] != start_row + (k - start)) {
          bulk_load(dst + start * kRowBytes, table + (size_t)start_row * kTakeQ,
                    (k - start) * kRowBytes, bar);
          if (k < rows) {
            start = k;
            start_row = my[k];
          }
        }
      }
      mbar_wait(bar, phase);
      phase ^= 1u;
      bulk_store(out + row0 * kTakeQ, dst, rows * kRowBytes);
    }
  }
  bulk_stores_done();
}

// ---- P2 (b): a traversal step's arithmetic without its row read ----

// The row source of step_only: the step's one row, which the kernel holds
// in registers. Its swizzle is 0 and every row index maps to that row, so
// once the step's loops unroll every float4 it reads has a constant index
// and the row stays in registers.
struct RegRows {
  static __device__ __forceinline__ const float4* row(const float4* rows,
                                                      int) {
    return rows;
  }
  static __device__ __forceinline__ int swizzle(int) { return 0; }
};

// A one-entry stack in a register: a step pushes at most one entry, and a
// walk that starts each step empty pops only what that step pushed.
struct RegStack {
  int top;
  __device__ __forceinline__ int& operator[](int) { return top; }
};

// n_steps steps of each lane's ray from the same state on the kernel's row
// (kNode: the node row from its root state, all 8 children unvisited;
// else the leaf row), each from an empty walk and a best hit at the ray's
// tmax. The dependence: after each step the lowest bit of its result
// (node: the next state xor the entry t's bits; leaf: the best hit's t,
// triangle, u and v bits xored) is xored into the lowest bit of the ray's
// origin and direction components, so every step's arithmetic depends on
// the one before and none can be hoisted out of the loop or dropped. The
// inverse direction stays the ray's first (a traversal computes it once a
// ray). Writes each lane's last origin and direction and the xor of its
// steps' results.
template <bool kNode, bool kAnyHit>
__global__ void __launch_bounds__(kThreadsMb)
step_only_kernel(const float4* __restrict__ rows, const float* __restrict__ o,
                 const float* __restrict__ d, const float* __restrict__ tmin,
                 const float* __restrict__ tmax, int n, int n_steps,
                 float* __restrict__ od_out, int* __restrict__ acc_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float4 row[32];  // only the float4 the step reads are loaded and kept
#pragma unroll
  for (int k = 0; k < 32; ++k) row[k] = rows[(kNode ? 0 : 32) + k];
  Ray r = load_ray(o, d, tmin, i);
  const float t_max = tmax[i];
  const int cur = kNode ? 0xFF : -2;
  RegStack stack{0};
  NoVisit none;
  int acc = 0;
  for (int s = 0; s < n_steps; ++s) {
    Walk w;
    w.init();
    Best b{t_max, -1, 0.0f, 0.0f};
    uint8_t flags = 0;
    const int nxt = step<RegRows>(row, 1, kNoVirtual, r, cur, kAnyHit,
                                  kMaxStack, stack, w, b, flags, none);
    const int res = kNode ? (nxt ^ __float_as_int(w.tent))
                          : (__float_as_int(b.t) ^ b.tri ^ __float_as_int(b.u) ^
                             __float_as_int(b.v));
    acc ^= res;
    const int h = res & 1;
    r.ox = __int_as_float(__float_as_int(r.ox) ^ h);
    r.oy = __int_as_float(__float_as_int(r.oy) ^ h);
    r.oz = __int_as_float(__float_as_int(r.oz) ^ h);
    r.dx = __int_as_float(__float_as_int(r.dx) ^ h);
    r.dy = __int_as_float(__float_as_int(r.dy) ^ h);
    r.dz = __int_as_float(__float_as_int(r.dz) ^ h);
  }
  float* od = od_out + 6 * (size_t)i;
  od[0] = r.ox;
  od[1] = r.oy;
  od[2] = r.oz;
  od[3] = r.dx;
  od[4] = r.dy;
  od[5] = r.dz;
  acc_out[i] = acc;
}

// ---- P3: the queue fetch in the three forms the kernels take ----

// the forms, the C entry's codes
constexpr int kQueueMemset = 0, kQueueWork = 1, kQueueThreshold = 2;

// The memset form: every lane asks at every round; `counter` was zeroed
// on the stream.
__global__ void __launch_bounds__(kThreadsMb)
queue_fetch_kernel(int* counter, int n, int* __restrict__ counts) {
  bool drained = false;
  while (!drained) {
    const int id = warp_fetch(counter, true, n, drained);
    if (id >= 0) atomicAdd(counts + id, 1);
  }
}

// The work-area form: the same from this launch's counter set `work`
// (zero); block 0 zeroes the other set `next` for the next launch.
__global__ void __launch_bounds__(kThreadsMb)
queue_fetch_work_kernel(int* work, int* next, int n,
                        int* __restrict__ counts) {
  zero_set(next);
  bool drained = false;
  while (!drained) {
    const int id = warp_fetch(work + kInput, true, n, drained);
    if (id >= 0) atomicAdd(counts + id, 1);
  }
}

// The threshold form, K4's loop (traversal_pool.cu pool_loop) without its
// traversal step: a warp claims items only when at least F lanes are idle,
// up to R fetches an iteration while a lane draws dead items; a fetch loads
// the item's tmin and tmax, writes a dead item (!(tmin <= tmax)) as
// out = tmax at once, and holds a live one for steps[item] iterations,
// after which out = tmin + steps. Lane 0 of each warp adds the warp's
// claims, the clock cycles it spent in its fetch rounds and its cycles in
// all to stats[0..2].
template <int F, int R>
__global__ void __launch_bounds__(kThreadsMb)
queue_fetch_threshold_kernel(int* work, int* next, int n,
                             const int* __restrict__ steps,
                             const float* __restrict__ tmin,
                             const float* __restrict__ tmax,
                             int* __restrict__ counts, float* __restrict__ out,
                             unsigned long long* __restrict__ stats) {
  zero_set(next);
  const long long start = clock64();
  int item = -1, left = 0;
  float val = 0.0f;
  bool drained = false;
  long long claims = 0, fetch_cycles = 0;  // warp-uniform
  for (;;) {  // warp-uniform: every lane reaches each ballot and fetch
    if (item >= 0 && left == 0) {
      out[item] = val;
      item = -1;
    }
    if (!drained && __popc(__ballot_sync(kFullMask, item < 0)) >= F) {
      const long long c0 = clock64();
      for (int round = 0; round < R; ++round) {
        if (!drained) ++claims;
        const int id = warp_fetch(work + kInput, item < 0, n, drained);
        bool dead = false;
        if (id >= 0) {
          atomicAdd(counts + id, 1);
          const float tn = tmin[id], tx = tmax[id];
          dead = !(tn <= tx);
          if (dead) {
            out[id] = tx;
          } else {
            item = id;
            left = steps[id];
            val = tn + (float)left;
          }
        }
        if (__ballot_sync(kFullMask, dead) == 0u) break;
      }
      fetch_cycles += clock64() - c0;
    }
    const bool run = item >= 0 && left > 0;
    if (__ballot_sync(kFullMask, run) == 0u) {
      if (drained && !__any_sync(kFullMask, item >= 0)) break;
      continue;  // an idle warp fetches again; a finished item retires
    }
    if (run) --left;
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(stats, (unsigned long long)claims);
    atomicAdd(stats + 1, (unsigned long long)fetch_cycles);
    atomicAdd(stats + 2, (unsigned long long)(clock64() - start));
  }
}

int blocks_for(int n) { return (n + kThreadsMb - 1) / kThreadsMb; }

// Opts `kernel` in to `bytes` of dynamic shared memory when it needs more
// than the default 48 KB; returns the CUDA error (cleared).
template <class Kernel>
int opt_in(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

template <int kRanks, int kWords>
int launch_chase_cluster(const float4* table, int n_rows, const int* idx0,
                         int n_chains, int n_steps, int lanes, int threads,
                         int* out, cudaStream_t s) {
  static ClusterOptIn opt;
  const int blocks = (n_chains * lanes + threads - 1) / threads;
  return launch_clusters(chase_rows_cluster_kernel<kRanks, kWords>, opt,
                         kRanks, threads, ClusterStage<kRanks>::bytes(n_rows),
                         (blocks + kRanks - 1) / kRanks, s, table, n_rows,
                         idx0, n_chains, n_steps, lanes, out);
}

// P1's launch in `mode` reading kWords float4 a step, the arguments
// checked by ctl_chase_rows (`staged`: the shared or cluster mode's bytes
// of a block's share).
template <int kWords>
int launch_chase(const float4* t4, int n_rows, const int* idx0, int n_chains,
                 int n_steps, int mode, int param, int lanes, int threads,
                 size_t staged, int* out, cudaStream_t s) {
  const int blocks = (n_chains * lanes + threads - 1) / threads;
  int err = 0;
  switch (mode) {
    case kChaseThread:
      chase_rows_kernel<kWords><<<blocks, threads, 0, s>>>(
          t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      break;
    case kChaseShared:
      err = opt_in(chase_rows_shared_kernel<kWords>, staged);
      if (err == 0) {
        chase_rows_shared_kernel<kWords><<<blocks, threads, staged, s>>>(
            t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      }
      break;
    case kChaseGroup: {
      auto kernel = param == 8    ? chase_rows_group_kernel<8, kWords>
                    : param == 16 ? chase_rows_group_kernel<16, kWords>
                                  : chase_rows_group_kernel<32, kWords>;
      kernel<<<blocks, threads, 0, s>>>(t4, n_rows, idx0, n_chains, n_steps,
                                        lanes, out);
      break;
    }
    case kChaseCluster: {
      auto launch = param == 1   ? launch_chase_cluster<1, kWords>
                    : param == 2 ? launch_chase_cluster<2, kWords>
                    : param == 4 ? launch_chase_cluster<4, kWords>
                                 : launch_chase_cluster<8, kWords>;
      return launch(t4, n_rows, idx0, n_chains, n_steps, lanes, threads, out,
                    s);
    }
    default: {
      const size_t bytes = (size_t)threads * (512 + 8);
      err = opt_in(chase_rows_bulk_kernel<kWords>, bytes);
      if (err == 0) {
        chase_rows_bulk_kernel<kWords><<<blocks, threads, bytes, s>>>(
            t4, n_rows, idx0, n_chains, n_steps, lanes, out);
      }
    }
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // namespace

// P1 in `mode` (0 thread, 1 shared, 2 group, 3 cluster, 4 bulk) with
// `param` (group: G = 8, 16 or 32 lanes a chain; cluster: n = 1, 2, 4 or
// 8 blocks; else unused), `lanes` threads a chain (a power of two up to
// 32, at least G), blocks of `threads` threads (a multiple of 32 up to
// kThreadsMb) and `words` float4 read a step (14 or 32). Returns a CUDA
// error code, or -1 for another mode, param, shape or words, or a table
// whose rows (shared: all, cluster: a block's share) do not fit a block's
// shared memory.
extern "C" int ctl_chase_rows(const float* table, int n_rows, const int* idx0,
                              int n_chains, int n_steps, int mode, int param,
                              int lanes, int threads, int words, int* out,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float4* t4 = reinterpret_cast<const float4*>(table);
  if (mode < kChaseThread || mode > kChaseBulk || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || threads < 32 || threads > kThreadsMb ||
      threads % 32 != 0 || (words != 14 && words != 32)) {
    return -1;
  }
  if (mode == kChaseGroup && param != 8 && param != 16 && param != 32) {
    return -1;
  }
  if (mode == kChaseGroup && lanes < param) return -1;
  if (mode == kChaseCluster && param != 1 && param != 2 && param != 4 &&
      param != 8) {
    return -1;
  }
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int ranks = mode == kChaseCluster ? param : 1;
  const size_t staged = (size_t)((n_rows + ranks - 1) / ranks) * 512;
  if ((mode == kChaseShared || mode == kChaseCluster) &&
      staged > (size_t)limit) {
    return -1;
  }
  if (n_chains <= 0) return (int)cudaGetLastError();
  auto launch = words == 14 ? launch_chase<14> : launch_chase<32>;
  return launch(t4, n_rows, idx0, n_chains, n_steps, mode, param, lanes,
                threads, staged, out, s);
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

namespace {

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// P2 (a)'s launch in `design`.
int launch_take(int design, const float4* table, const int* idx, long long n,
                float4* out, cudaStream_t s) {
  const long long threads = design == kTakeFlat ? n * kTakeQ : n;
  if (design == kTakeThread) {
    gather_take_thread_kernel
        <<<(unsigned)((threads + kThreadsMb - 1) / kThreadsMb), kThreadsMb, 0,
           s>>>(table, idx, n, out);
  } else if (design == kTakeFlat) {
    gather_take_flat_kernel
        <<<(unsigned)((threads + kThreadsMb - 1) / kThreadsMb), kThreadsMb, 0,
           s>>>(table, idx, n, out);
  } else {
    const size_t bytes = (size_t)kTileLanes * kTileRows * kTakeQ * 16 +
                         (size_t)kTileLanes * kTileStride * 4 +
                         (size_t)kTileLanes * 8;
    const int err = opt_in(gather_take_bulk_kernel, bytes);
    if (err != 0) return err;
    const long long rounds =
        ((n + kTileRows - 1) / kTileRows + kTileLanes - 1) / kTileLanes;
    const int sms = sm_count();
    gather_take_bulk_kernel
        <<<(unsigned)(rounds < sms ? rounds : sms), kTileLanes, bytes, s>>>(
            table, idx, n, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// P2 (a): out (n rows of 4q float32) = the rows idx of table (n_rows rows
// of 4q float32), as table.index_select(0, idx) computes it; every index in
// [0, n_rows). design: 0 thread, 1 flat, 2 bulk (idx 16-byte aligned).
// Returns a CUDA error code, or -1 for another design or q (kTakeQ).
extern "C" int ctl_gather_take(const float* table, int n_rows, int q,
                               const int* idx, long long n, int design,
                               float* out, void* stream) {
  if (design < kTakeThread || design > kTakeBulk || q != kTakeQ ||
      n_rows <= 0) {
    return -1;
  }
  if (n <= 0) return (int)cudaGetLastError();
  return launch_take(design, reinterpret_cast<const float4*>(table), idx, n,
                     reinterpret_cast<float4*>(out), (cudaStream_t)stream);
}

extern "C" int ctl_loop_only(const float* x0, int n, int n_steps, float* out,
                             void* stream) {
  if (n > 0) {
    loop_only_kernel<<<blocks_for(n), kThreadsMb, 0, (cudaStream_t)stream>>>(
        x0, n, n_steps, out);
  }
  return (int)cudaGetLastError();
}

namespace {

template <bool kNode, bool kAnyHit>
int launch_step_only(const float* rows, const float* o, const float* d,
                     const float* tmin, const float* tmax, int n, int n_steps,
                     int threads, float* od_out, int* acc_out,
                     cudaStream_t s) {
  step_only_kernel<kNode, kAnyHit><<<(n + threads - 1) / threads, threads, 0,
                                     s>>>(
      reinterpret_cast<const float4*>(rows), o, d, tmin, tmax, n, n_steps,
      od_out, acc_out);
  return (int)cudaGetLastError();
}

template <bool kNode, bool kAnyHit>
int step_only_blocks() {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, step_only_kernel<kNode, kAnyHit>, kThreadsMb, 0);
  return per_sm;
}

}  // namespace

// P2 (b): n lanes of n_steps steps on rows (2 rows of 128 float32: the
// node row, then the leaf row), of the node row (node != 0) or the leaf
// row, any_hit or closest, in blocks of `threads` (32 or kThreadsMb);
// rays o, d (n x 3), tmin, tmax (n). Writes od_out (n x 6: each lane's last
// origin and direction) and acc_out (n: the xor of its steps' results).
// Returns a CUDA error code, or -1 for other threads.
extern "C" int ctl_step_only(const float* rows, const float* o, const float* d,
                             const float* tmin, const float* tmax, int n,
                             int n_steps, int node, int any_hit, int threads,
                             float* od_out, int* acc_out, void* stream) {
  if (threads != 32 && threads != kThreadsMb) return -1;
  if (n <= 0) return (int)cudaGetLastError();
  auto launch = node ? (any_hit ? launch_step_only<true, true>
                                : launch_step_only<true, false>)
                     : (any_hit ? launch_step_only<false, true>
                                : launch_step_only<false, false>);
  return launch(rows, o, d, tmin, tmax, n, n_steps, threads, od_out, acc_out,
                (cudaStream_t)stream);
}

// The blocks of kThreadsMb threads of step_only's kernel (node, any_hit)
// that one SM holds at once (its full occupancy).
extern "C" int ctl_step_only_blocks(int node, int any_hit) {
  return node ? (any_hit ? step_only_blocks<true, true>()
                         : step_only_blocks<true, false>())
              : (any_hit ? step_only_blocks<false, true>()
                         : step_only_blocks<false, false>());
}

// P3 in `form`: 0 memset (`counter` one int32, zeroed here on the
// stream); 1 work area and 2 threshold (`counter` the stream's work area,
// warp_queue.cuh, counting in its set `set`, which must be zero). On one
// warp a block and a block an SM (`warp` != 0), or on persistent blocks of
// kThreadsMb threads that fill every SM; no more blocks than n items need.
// counts must hold n zeros. The threshold form reads steps, tmin and tmax
// (n each), writes out (n) and adds its claims, fetch cycles and cycles to
// stats (3 uint64, zero). Returns a CUDA error code, or -1 for another
// form or set.
extern "C" int ctl_queue_fetch(int form, int n, int* counter, int set,
                               const int* steps, const float* tmin,
                               const float* tmax, int* counts, float* out,
                               unsigned long long* stats, int warp,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (form < kQueueMemset || form > kQueueThreshold || set < 0 || set > 1) {
    return -1;
  }
  if (n <= 0) return (int)cudaGetLastError();
  auto blocks = [&](auto kernel) {
    if (!warp) return persistent_blocks(kernel, kThreadsMb, n);
    const int sms = sm_count(), need = (n + 31) / 32;
    return need < sms ? need : sms;
  };
  const int threads = warp ? 32 : kThreadsMb;
  if (form == kQueueMemset) {
    cudaMemsetAsync(counter, 0, sizeof(int), s);
    queue_fetch_kernel<<<blocks(queue_fetch_kernel), threads, 0, s>>>(
        counter, n, counts);
    return (int)cudaGetLastError();
  }
  int* work = counter + kSet * set;
  int* next = counter + kSet * (1 - set);
  if (form == kQueueWork) {
    queue_fetch_work_kernel<<<blocks(queue_fetch_work_kernel), threads, 0,
                              s>>>(work, next, n, counts);
  } else {
    auto kernel = queue_fetch_threshold_kernel<kFetchIdle, kFetchRounds>;
    kernel<<<blocks(kernel), threads, 0, s>>>(work, next, n, steps, tmin, tmax,
                                              counts, out, stats);
  }
  return (int)cudaGetLastError();
}

// The blocks of kThreadsMb threads of P3's kernel in `form` that one SM
// holds at once (the full-occupancy grid is that many a SM, or fewer
// where the items need fewer), or -1 for another form.
extern "C" int ctl_queue_blocks(int form) {
  int per_sm = 0;
  if (form == kQueueMemset) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, queue_fetch_kernel,
                                                  kThreadsMb, 0);
  } else if (form == kQueueWork) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, queue_fetch_work_kernel, kThreadsMb, 0);
  } else if (form == kQueueThreshold) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, queue_fetch_threshold_kernel<kFetchIdle, kFetchRounds>,
        kThreadsMb, 0);
  } else {
    return -1;
  }
  return per_sm;
}
