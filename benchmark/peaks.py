"""Published peaks of one NVIDIA H100 SXM (data sheet, 700 W) and the
least-time arithmetic the roofline metrics use. Frozen copies of the
program's bound arithmetic (``utils/microbench.bound_ms``, the traversal
bound of ``chip_smoke.trav_bound`` and P2 (a)'s gather bound), so that the
yardstick does not move when the program does."""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12    # HBM3
PEAK_FLOPS_F32 = 67e12        # float32 outside the tensor cores

# a BVH node step's float32 operations: 26 per child (6 subtractions and 6
# products for the slab distances, 12 min/max, 2 compares) for 8 children;
# a leaf step does more, so steps x this stays a lower bound
NODE_STEP_FLOPS = 26 * 8
# bytes a traced ray moves at least: o and d in (24), tmin and tmax in (8),
# its hit out (t, tri, u, v, steps, flags: 21)
RAY_BYTES = 24 + 8 + 21


def least_seconds(n_bytes: float, n_flops: float) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the peak float32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_flops / PEAK_FLOPS_F32)


def traversal_least_seconds(steps: int, rays: int, table_bytes: int) -> float:
    """Least time of the traversal kernels over a traced window: every
    traced ray in and its hit out, each traversal table once, and the
    steps the kernels counted times a node step's operations."""
    return least_seconds(rays * RAY_BYTES + table_bytes, steps * NODE_STEP_FLOPS)


def gather_least_seconds(n_bytes: int) -> float:
    """Least time of a gather: its output and its indices once."""
    return n_bytes / PEAK_BYTES_PER_S
