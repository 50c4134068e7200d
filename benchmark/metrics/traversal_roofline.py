"""Share of their roofline that the traversal kernels K1-K3 reach: their
least time (every traced ray in and its hit out, each traversal table
once, and the steps the tracer counted times a node step's operations; see
``benchmark/peaks.py``) over their device time in the traced passes, by
kernel name. Read only where the tracer counts its traversal steps."""
from ..peaks import traversal_least_seconds

KERNELS = ("traverse8", "top_visits", "treelet_hits")


def read(run):
    steps, rays = run.delta("steps"), run.delta("rays")
    secs = run.summary.kernel_seconds(KERNELS)
    if not steps or not rays or secs <= 0:
        return None
    return (100.0 * traversal_least_seconds(steps, rays, run.table_bytes) / secs, "%")
