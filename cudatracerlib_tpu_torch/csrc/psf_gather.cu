// The game frame's path-space filter gather for NVIDIA Hopper (sm_90a):
// ops/psf.py wraps it and holds it against its plain PyTorch version.
//
// Replaces no Pallas kernel: the JAX package's filter
// (cudatracerlib_tpu/models/game.py, psf_pass's accum over
// ops/hashgrid.gather_neighbors) is jnp, which XLA fuses on the TPU. The
// port's plain version materialises the whole neighbourhood, a query's 8
// cells x 16 slots of 12-float rows ((B, 128, 12) float32: 6.4 GB a
// 1024^2 frame), and reduces it in further passes. This kernel fuses the
// gather with the two hard tests and the sums, so nothing of size
// (B, 128, .) exists: it writes (B, 3) sums and (B,) counts.
//
// What bounds it: the row reads. Slot k of cell j of query i is the row
// start[i][j] + k of the sorted cache; neighbouring pixels share most of
// their 8 cells, and a cell's first 16 rows are a few thousand distinct
// rows per frame, so the reads come from L1/L2. Device memory holds only
// the queries (position, normal, radius, 8 ranges: 92 bytes), the outputs
// (16 bytes) and the distinct rows once: ~100 MB a 1024^2 frame.
//
// Design: one thread a query; blocks take consecutive pixels, so a warp's
// 32 neighbouring pixels walk mostly the same cells and one L1 line serves
// the whole warp. A row is read as read-only 16-byte loads: the first
// float4 (position, Li.r) for the distance test, the other two (Li.gb,
// the normal) only for a row within the radius. The sums stay in
// registers.
//
// Same arithmetic as the plain version: the build's -fmad=false keeps
// every product and sum rounded on its own, the distance is
// ((dx*dx + dy*dy) + dz*dz) <= r*r and the normal test
// ((n.x*ns.x + n.y*ns.y) + n.z*ns.z) > 0.8 in that order, and the slots
// are visited in the plain version's layout (cell-major, k < min(count,
// kMaxPerCell)). Only the order of the float32 sums differs.
//
// The row layout is ops/psf.py's cache_rows: position, Li, normal,
// padding, 12 float32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCells = 8;
constexpr int kMaxPerCell = 16;   // ops/psf.py's MAX_PER_CELL
constexpr int kRowQ = 3;   // float4 a row: position, Li, normal, padding

// row float4 0: (p.x, p.y, p.z, Li.r); 1: (Li.g, Li.b, n.x, n.y);
// 2: (n.z, 0, 0, 0)
__global__ void __launch_bounds__(kThreads)
psf_gather_kernel(const float4* __restrict__ rows, const int* __restrict__ start,
                  const int* __restrict__ count, const float* __restrict__ p,
                  const float* __restrict__ ns, const float* __restrict__ radius,
                  int n, float* __restrict__ acc,
                  float* __restrict__ cnt) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float px = __ldg(p + 3 * i), py = __ldg(p + 3 * i + 1),
              pz = __ldg(p + 3 * i + 2);
  const float nx = __ldg(ns + 3 * i), ny = __ldg(ns + 3 * i + 1),
              nz = __ldg(ns + 3 * i + 2);
  const float r = __ldg(radius + i);
  const float r2 = r * r;
  float ax = 0.0f, ay = 0.0f, az = 0.0f, c = 0.0f;
  for (int j = 0; j < kCells; ++j) {
    const int s = __ldg(start + kCells * i + j);
    const int m = min(__ldg(count + kCells * i + j), kMaxPerCell);
    for (int k = 0; k < m; ++k) {
      const float4* row = rows + (size_t)(s + k) * kRowQ;
      const float4 a = __ldg(row);
      const float dx = a.x - px, dy = a.y - py, dz = a.z - pz;
      const float d2 = (dx * dx + dy * dy) + dz * dz;
      if (!(d2 <= r2)) continue;
      const float4 b = __ldg(row + 1);
      const float nz_row = __ldg(reinterpret_cast<const float*>(row + 2));
      if ((b.z * nx + b.w * ny) + nz_row * nz > 0.8f) {
        ax += a.w;
        ay += b.x;
        az += b.y;
        c += 1.0f;
      }
    }
  }
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
  cnt[i] = c;
}

}  // namespace

// acc (n, 3) and cnt (n,) of n queries: over the rows of each query's 8
// cell ranges (start, count: (n, 8) int32), slots k < min(count,
// kMaxPerCell), the rows (n_rows rows of 12 float32, 16-byte aligned)
// within radius of p whose normal's dot with ns passes 0.8: the sum of
// their Li and their number. Every start + k below min(count,
// kMaxPerCell) must lie in [0, n_rows) (query_ranges' ranges do).
// Returns a CUDA error code, or -1 for n_rows below 1.
extern "C" int ctl_psf_gather(const float* rows, int n_rows, const int* start,
                              const int* count, const float* p, const float* ns,
                              const float* radius, int n, float* acc, float* cnt,
                              void* stream) {
  if (n_rows <= 0) return -1;
  if (n > 0) {
    psf_gather_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                        (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(rows), start, count, p, ns, radius, n, acc,
        cnt);
  }
  return (int)cudaGetLastError();
}
