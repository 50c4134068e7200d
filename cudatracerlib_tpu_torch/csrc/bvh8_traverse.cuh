// One ray's traversal of a BVH8 fat-row table, shared by the port's four
// traversal kernels: traversal8.cu (K1), traversal_tt.cu (K2, K3) and
// traversal_pool.cu (K4).
//
// The table is (R, 128) float32 row-major (scene/bvh8.py layout), read
// through const float4* __restrict__:
//   node row: lo_x[8] lo_y[8] lo_z[8] hi_x[8] hi_y[8] hi_z[8] links[8]
//   leaf row: v0x[12] v0y v0z e1x e1y e1z e2x e2y e2z, ids[12] at 108
// link >= 0: node row; -1: empty; <= -2: leaf row (-2 - link).
//
// One thread runs one ray's state machine:
// - a node step slab-tests the 8 children and descends near-child-first; a
//   stack entry is (row << 8) | unvisited-child mask, so a popped node is
//   re-tested against the current best t;
// - a leaf step runs Moller-Trumbore on its 12 triangles, rejecting
//   |det| < 1e-12 and accepting tmin < t < t_best;
// - ties on t take the lowest child or triangle index (strict < below), as
//   jnp.argmin does in the TPU kernels;
// - the stack is a ring of `stack_depth` entries in local memory: a push onto
//   a full stack drops the oldest entry and sets flag bit 1 (the TPU kernels
//   drop it silently); a ray still running after `max_iters` steps stops with
//   its best hit so far and sets flag bit 0;
// - a leaf whose row is at or beyond `n_real` is a VIRTUAL leaf (K2's cut
//   edges into treelet slabs): the step calls visit(row - n_real, entry t of
//   the descend that reached it) and pops, testing no triangles.
//
// The state machine is split in three: Walk::init (an empty stack), step
// (one row) and traverse (the loop over steps with the cap). K1, K2 and K3
// run traverse; K4 runs step itself, so that a lane can take a new ray
// between two steps. K1's group design (traversal8.cu, group_traverse)
// runs the same steps on a group of lanes, one child or triangle a lane,
// with step's float expressions in the same order and a reduction that
// keeps what the strict-< scans keep, its ring stack spread over the
// group's registers.
//
// What bounds a traversal on an H100 (PERF.md): where most lanes are live
// and the table is small (Cornell, veach-mis, K2's top tables), the
// instruction stream under divergence: one thread runs a node step's 8
// slab tests or a leaf step's 12 triangle tests in series, and a warp
// runs its node-step and leaf-step lanes one after the other and waits
// for its slowest ray.
// Where few lanes are live on a large table (the treelet fallback), the
// chain of dependent row fetches of the slowest ray: a step's fetch
// (~0.5-0.7 us from L2 or HBM) plus its serial tests; the group design
// shortens the second part and writes the dead lanes without a fetch.
//
// step and traverse are templates over where a row comes from; a source
// gives a row's base pointer (row) and its swizzle:
// - the global source (GlobalRows) reads the table in device memory through
//   L1/L2, one LDG.E.128.CONSTANT per float4. K3 and the global variants
//   of K1, K2 and K4 use it;
// - the shared source (SharedRows) reads the block's copy of the table in
//   shared memory, staged by stage_rows with 16-byte cp.async copies
//   (LDGSTS.E.BYPASS.128) and swizzled: float4 k of row i at i * 32 +
//   (k ^ (i & 31)), so that the lanes of a quarter-warp reading one column
//   of rows that differ in i & 7 fall on different banks. Its node and leaf
//   steps compile to LDS.128 (43 per kernel, no generic LD; chip_smoke.py
//   checks the SASS). The shared variants of K1, K2 and K4 use it.
// csrc/schedule_probe.cu adds the sources of K3's rejected designs (a slab
// over a cluster's shared memory; a slab split between shared and device
// memory).
// The ring stack is the caller's (Stack: any type with int& operator[]);
// every kernel keeps it in local memory, an int[kMaxStack]. Stacks in
// shared memory tied with it (csrc/schedule_probe.cu, PERF.md).
// A row source changes where a load goes, never the arithmetic or its
// order, so every variant equals every other bit for bit.
//
// Built with -fmad=false: nvcc then contracts no a*b+c into an FMA, the
// kernels round op for op like their plain PyTorch versions
// (ops/traversal8.py::_lockstep), and the two agree exactly. max/min
// propagate NaN like torch.maximum/torch.minimum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_queue.cuh"

namespace ctl {

constexpr int kDone = -1;
constexpr int kPop = -0x40000000;
constexpr int kMaxStack = 64;
constexpr int kThreads = 128;
// threads of a shared-table block: one block per SM (the table fills its
// shared memory), as many threads as K1's and K2's registers allow at that
// (at most 128 each; they take 80-100)
constexpr int kPersistThreads = 512;
constexpr int kNoVirtual = 0x7fffffff;

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__device__ __forceinline__ float safe_inv(float d) {
  const float eps = 1e-20f;
  float s = fabsf(d) < eps ? (d >= 0.0f ? eps : -eps) : d;
  return 1.0f / s;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmn;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ tmin,
                                        int i) {
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.tmn = tmin[i];
  return r;
}

struct Best {
  float t;  // starts at the ray's tmax
  int tri;
  float u, v;
};

// Where a step reads its row: rows are 32 float4; float4 k of row i is at
// row(table, i) + (k ^ swizzle(i)). The global source is the table in
// device memory, read through L1/L2 as it is stored; the shared source is
// the block's swizzled copy in shared memory (stage_rows below), so that
// the 8 lanes of a quarter-warp reading one column of rows that differ in
// i & 7 fall on different banks.
struct GlobalRows {
  static __device__ __forceinline__ const float4* row(const float4* table,
                                                      int i) {
    return table + (size_t)i * 32;
  }
  static __device__ __forceinline__ int swizzle(int) { return 0; }
};

struct SharedRows {
  static __device__ __forceinline__ const float4* row(const float4* table,
                                                      int i) {
    return table + (size_t)i * 32;
  }
  static __device__ __forceinline__ int swizzle(int row) { return row & 31; }
};

struct NoVisit {
  __device__ __forceinline__ void operator()(int, float) {}
};

// A ray's traversal state besides its current row, best hit and ring stack
// (an int[kMaxStack] of the caller's, kept apart so that these scalars stay
// in registers): the stack's top and fill, and the entry t of the last
// descend.
struct Walk {
  int pos, n;
  float tent;  // entry t of the last descend

  __device__ __forceinline__ void init() {
    pos = 0;
    n = 0;
    tent = 0.0f;
  }
};

// One step of the ray from state `cur` (not kDone): reads one row, updates
// the best hit, the stack and the flags, and returns the next state.
template <class Rows = GlobalRows, class Stack, class Visit>
__device__ __forceinline__ int step(const float4* __restrict__ table,
                                    int n_rows, int n_real, const Ray& r,
                                    int cur, bool anyh, int stack_depth,
                                    Stack& stack, Walk& w, Best& b,
                                    uint8_t& flags, Visit& visit) {
  int row_idx = cur >= 0 ? (cur >> 8) : (-2 - cur);
  int nxt;
  if (cur < 0 && row_idx >= n_real) {
    visit(row_idx - n_real, w.tent);
    nxt = kPop;
  } else {
    row_idx = min(max(row_idx, 0), n_rows - 1);
    const float4* row = Rows::row(table, row_idx);
    const int sw = Rows::swizzle(row_idx);
    if (cur >= 0) {
      float best_t = __int_as_float(0x7f800000);
      int best_j = 0, link_best = 0, elig_bits = 0;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 lx = row[g ^ sw], ly = row[(2 + g) ^ sw];
        const float4 lz = row[(4 + g) ^ sw], hx = row[(6 + g) ^ sw];
        const float4 hy = row[(8 + g) ^ sw], hz = row[(10 + g) ^ sw];
        const float4 lk = row[(12 + g) ^ sw];
        const float alx[4] = {lx.x, lx.y, lx.z, lx.w};
        const float aly[4] = {ly.x, ly.y, ly.z, ly.w};
        const float alz[4] = {lz.x, lz.y, lz.z, lz.w};
        const float ahx[4] = {hx.x, hx.y, hx.z, hx.w};
        const float ahy[4] = {hy.x, hy.y, hy.z, hy.w};
        const float ahz[4] = {hz.x, hz.y, hz.z, hz.w};
        const int alk[4] = {__float_as_int(lk.x), __float_as_int(lk.y),
                            __float_as_int(lk.z), __float_as_int(lk.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = 4 * g + k;
          const float t0x = (alx[k] - r.ox) * r.ix, t1x = (ahx[k] - r.ox) * r.ix;
          const float t0y = (aly[k] - r.oy) * r.iy, t1y = (ahy[k] - r.oy) * r.iy;
          const float t0z = (alz[k] - r.oz) * r.iz, t1z = (ahz[k] - r.oz) * r.iz;
          const float tn = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)),
                                maxp(minp(t0z, t1z), r.tmn));
          const float tf = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)),
                                minp(maxp(t0z, t1z), b.t));
          const bool elig = (tn <= tf) && alk[k] != kDone && ((cur >> j) & 1);
          if (elig) {
            elig_bits |= 1 << j;
            if (tn < best_t) {
              best_t = tn;
              best_j = j;
              link_best = alk[k];
            }
          }
        }
      }
      if (best_t < __int_as_float(0x7f800000)) {
        nxt = link_best >= 0 ? ((link_best << 8) | 0xFF) : link_best;
        w.tent = best_t;
        const int remaining = elig_bits & ~(1 << best_j);
        if (remaining != 0) {
          w.pos = w.pos + 1 == stack_depth ? 0 : w.pos + 1;
          stack[w.pos] = (cur & ~0xFF) | remaining;
          if (w.n == stack_depth) {
            flags |= 2;
          } else {
            ++w.n;
          }
        }
      } else {
        nxt = kPop;
      }
    } else {
      float hit_t = __int_as_float(0x7f800000), hit_u = 0.0f, hit_v = 0.0f;
      int hit_id = -1;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float4 q[9];
#pragma unroll
        for (int a = 0; a < 9; ++a) q[a] = row[(3 * a + g) ^ sw];
        const float4 qi = row[(27 + g) ^ sw];
        const int ids[4] = {__float_as_int(qi.x), __float_as_int(qi.y),
                            __float_as_int(qi.z), __float_as_int(qi.w)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float c[9];
#pragma unroll
          for (int a = 0; a < 9; ++a) {
            c[a] = k == 0 ? q[a].x : k == 1 ? q[a].y : k == 2 ? q[a].z : q[a].w;
          }
          const float v0x = c[0], v0y = c[1], v0z = c[2];
          const float e1x = c[3], e1y = c[4], e1z = c[5];
          const float e2x = c[6], e2y = c[7], e2z = c[8];
          const float px = r.dy * e2z - r.dz * e2y;
          const float py = r.dz * e2x - r.dx * e2z;
          const float pz = r.dx * e2y - r.dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
          const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = ids[k] != -1 && fabsf(det) >= 1e-12f && u >= 0.0f &&
                          v >= 0.0f && u + v <= 1.0f && t > r.tmn && t < b.t;
          if (ok && t < hit_t) {
            hit_t = t;
            hit_id = ids[k];
            hit_u = u;
            hit_v = v;
          }
        }
      }
      const bool leaf_hit = hit_t < __int_as_float(0x7f800000);
      if (leaf_hit) {
        b.t = hit_t;
        b.tri = hit_id;
        b.u = hit_u;
        b.v = hit_v;
      }
      nxt = (leaf_hit && anyh) ? kDone : kPop;
    }
  }
  if (nxt == kPop) {
    if (w.n > 0) {
      nxt = stack[w.pos];
      w.pos = w.pos == 0 ? stack_depth - 1 : w.pos - 1;
      --w.n;
    } else {
      nxt = kDone;
    }
  }
  return nxt;
}

// Runs the ray from state `cur` ((root << 8) | 0xFF) until it is done, its
// step cap is hit, or (anyh) its first leaf hit, on the caller's stack.
template <class Rows, class Stack, class Visit>
__device__ __forceinline__ void traverse(const float4* __restrict__ table,
                                         int n_rows, int n_real, const Ray& r,
                                         int cur, bool anyh, int stack_depth,
                                         int max_iters, Best& b, int& steps,
                                         uint8_t& flags, Visit& visit,
                                         Stack& stack) {
  Walk w;
  w.init();
  while (cur != kDone) {
    if (steps >= max_iters) {
      flags |= 1;
      break;
    }
    ++steps;
    cur = step<Rows>(table, n_rows, n_real, r, cur, anyh, stack_depth, stack,
                     w, b, flags, visit);
  }
}

// The same on a ring stack in local memory, from the global source.
template <class Visit>
__device__ __forceinline__ void traverse(const float4* __restrict__ table,
                                         int n_rows, int n_real, const Ray& r,
                                         int cur, bool anyh, int stack_depth,
                                         int max_iters, Best& b, int& steps,
                                         uint8_t& flags, Visit& visit) {
  int stack[kMaxStack];
  traverse<GlobalRows>(table, n_rows, n_real, r, cur, anyh, stack_depth,
                       max_iters, b, steps, flags, visit, stack);
}

// The parameters of a K1 or K4 kernel (traversal8.cu, traversal_pool.cu), and
// the per-ray arguments of K1's trace_ray from them (the table given).
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

// ---- the shared-table variants of K1 and K2 --------------------------------

// Copies n_rows rows of the (., 128) table, every `stride`-th from row 0
// on, into the block's shared memory as local rows 0, 1, ...: float4 k of
// local row j at j * 32 + (k ^ (j & 31)), with 16-byte cp.async copies (all
// in flight at once, through L2 only), and waits for the whole block.
__device__ __forceinline__ void stage_rows(float4* rows,
                                           const float4* __restrict__ table,
                                           int n_rows, int stride = 1) {
  const int n = n_rows * 32;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = i >> 5;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(
        rows + row * 32 + ((i & 31) ^ SharedRows::swizzle(row)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(table + (size_t)row * stride * 32 + (i & 31)));
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

constexpr int kMaxDevices = 64;

// What a shared-table kernel's launch needs from the runtime, kept for each
// device so that a launch asks the runtime nothing: the dynamic shared
// bytes the kernel is opted in to, and the SM count. One per kernel (a
// static beside its launch).
struct SharedOptIn {
  size_t bytes[kMaxDevices] = {};
  int sms[kMaxDevices] = {};
};

// The grid of a shared-table launch of `kernel` on the current device: one
// block of `threads` per SM, no more than `n_rays` needs, in *blocks. Opts
// the kernel in to `bytes` of dynamic shared memory the first time it asks
// for that many on this device. Returns the CUDA error: a table over the
// card's limit is refused here (the caller raises), and the refusal is
// cleared from the runtime's last error so that the next launch does not
// report it.
template <class Kernel>
int shared_grid(Kernel kernel, SharedOptIn& opt, int threads, size_t bytes,
                int n_rays, int* blocks) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (opt.bytes[dev] < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    opt.bytes[dev] = bytes;
  }
  if (opt.sms[dev] == 0) {
    cudaDeviceGetAttribute(&opt.sms[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  const int need = (n_rays + threads - 1) / threads;
  *blocks = need < opt.sms[dev] ? need : opt.sms[dev];
  return 0;
}

// Zeroes the ray queue's counter `next_ray` on the stream and launches
// `kernel` on shared_grid's grid with `bytes` of dynamic shared memory;
// returns the first CUDA error.
template <class Kernel, class... Args>
int launch_shared(Kernel kernel, SharedOptIn& opt, int threads, size_t bytes,
                  int n_rays, int* next_ray, cudaStream_t stream,
                  Args... args) {
  int blocks = 0;
  const int err = shared_grid(kernel, opt, threads, bytes, n_rays, &blocks);
  if (err != 0) return err;
  cudaMemsetAsync(next_ray, 0, sizeof(int), stream);
  kernel<<<blocks, threads, bytes, stream>>>(args..., next_ray);
  return (int)cudaGetLastError();
}

}  // namespace ctl
