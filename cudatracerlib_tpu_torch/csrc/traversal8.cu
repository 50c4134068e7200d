// BVH8 fat-row traversal for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel cudatracerlib_tpu/ops/traversal_pl.py::_traverse_kernel
// (and the XLA loop cudatracerlib_tpu/ops/traversal8.py::intersect_wide). It
// computes what that kernel computes: the closest hit (t, tri, u, v) of each
// ray against the unified 8-wide fat-row BVH (scene/bvh8.py layout), or any
// hit for shadow rays, with a per-ray root row and per-ray any-hit flag.
//
// What bounds it on this card: a Cornell-class table is a few hundred 512-byte
// rows, so it sits in L1/L2 after the first touches. The kernel is bound by
// warp divergence (each thread runs its own data-dependent loop) and by the
// latency of the dependent row loads, not by device-memory bandwidth.
//
// The design is simple on purpose; making it fast is later work:
// - one thread per ray, a private stack in local memory;
// - the table stays (R, 128) row-major in device memory, read through
//   const float4* __restrict__, with no size cap and no transpose;
// - a node step slab-tests the 8 children and descends near-child-first; a
//   stack entry is (row << 8) | unvisited-child mask, so a popped node is
//   re-tested against the current best t;
// - a leaf step runs Moller-Trumbore on its 12 triangles, rejecting
//   |det| < 1e-12 and accepting tmin < t < t_best;
// - ties on t take the lowest child or triangle index (strict < below), as
//   jnp.argmin does in the TPU kernel;
// - the stack is a ring of `stack_depth` entries: a push onto a full stack
//   drops the oldest entry and sets flag bit 1 (the TPU kernels drop it
//   silently); a ray still running after `max_iters` steps stops with its
//   best hit so far and sets flag bit 0.
//
// Built with -fmad=false: nvcc then contracts no a*b+c into an FMA, the
// kernel rounds op for op like the plain PyTorch version
// (cudatracerlib_tpu_torch/ops/traversal8.py::intersect_wide), and the two
// agree exactly. max/min propagate NaN like torch.maximum/torch.minimum.
//
// The launch goes on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDone = -1;
constexpr int kPop = -0x40000000;
constexpr int kMaxStack = 64;
constexpr int kThreads = 128;

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

  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  const float tmn = tmin[i];
  const bool anyh = any_hit || (any_mask != nullptr && any_mask[i] != 0);
  float t_best = tmax[i];
  int tri_best = -1;
  float u_best = 0.0f, v_best = 0.0f;

  int stack[kMaxStack];
  int pos = 0, n = 0, steps = 0;
  uint8_t flags = 0;
  int cur = ((roots != nullptr ? roots[i] : 0) << 8) | 0xFF;

  while (cur != kDone) {
    if (steps >= max_iters) {
      flags |= 1;
      break;
    }
    ++steps;
    int row_idx = cur >= 0 ? (cur >> 8) : (-2 - cur);
    row_idx = min(max(row_idx, 0), n_rows - 1);
    const float4* row = table + (size_t)row_idx * 32;
    int nxt;
    if (cur >= 0) {
      // node row: lo_x[8] lo_y[8] lo_z[8] hi_x[8] hi_y[8] hi_z[8] links[8]
      float best_t = __int_as_float(0x7f800000);
      int best_j = 0, link_best = 0, elig_bits = 0;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 lx = row[g], ly = row[2 + g], lz = row[4 + g];
        const float4 hx = row[6 + g], hy = row[8 + g], hz = row[10 + g];
        const float4 lk = row[12 + g];
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
          const float t0x = (alx[k] - ox) * ix, t1x = (ahx[k] - ox) * ix;
          const float t0y = (aly[k] - oy) * iy, t1y = (ahy[k] - oy) * iy;
          const float t0z = (alz[k] - oz) * iz, t1z = (ahz[k] - oz) * iz;
          const float tn = maxp(maxp(minp(t0x, t1x), minp(t0y, t1y)),
                                maxp(minp(t0z, t1z), tmn));
          const float tf = minp(minp(maxp(t0x, t1x), maxp(t0y, t1y)),
                                minp(maxp(t0z, t1z), t_best));
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
        const int remaining = elig_bits & ~(1 << best_j);
        if (remaining != 0) {
          pos = pos + 1 == stack_depth ? 0 : pos + 1;
          stack[pos] = (cur & ~0xFF) | remaining;
          if (n == stack_depth) {
            flags |= 2;
          } else {
            ++n;
          }
        }
      } else {
        nxt = kPop;
      }
    } else {
      // leaf row: v0x[12] v0y v0z e1x e1y e1z e2x e2y e2z, ids[12] at 108
      float hit_t = __int_as_float(0x7f800000), hit_u = 0.0f, hit_v = 0.0f;
      int hit_id = -1;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        float4 q[9];
#pragma unroll
        for (int a = 0; a < 9; ++a) q[a] = row[3 * a + g];
        const float4 qi = row[27 + g];
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
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const float inv_det = fabsf(det) < 1e-12f ? 0.0f : 1.0f / det;
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool ok = ids[k] != -1 && fabsf(det) >= 1e-12f && u >= 0.0f &&
                          v >= 0.0f && u + v <= 1.0f && t > tmn && t < t_best;
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
        t_best = hit_t;
        tri_best = hit_id;
        u_best = hit_u;
        v_best = hit_v;
      }
      nxt = (leaf_hit && anyh) ? kDone : kPop;
    }
    if (nxt == kPop) {
      if (n > 0) {
        cur = stack[pos];
        pos = pos == 0 ? stack_depth - 1 : pos - 1;
        --n;
      } else {
        cur = kDone;
      }
    } else {
      cur = nxt;
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
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
