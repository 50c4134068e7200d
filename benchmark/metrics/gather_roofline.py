"""Share of their roofline that the gathers reach: for each
``aten::index`` / ``index_select`` / ``gather`` op in the traced passes, its
output and index bytes once over the memory rate, summed, over the device
time of the kernels those ops launched (P2 (a)'s bound)."""
from ..peaks import gather_least_seconds


def read(run):
    g = run.summary.gathers
    secs = sum(s for _, _, s in g)
    nbytes = sum(b for _, b, _ in g)
    if secs <= 0 or nbytes <= 0:
        return None
    return (100.0 * gather_least_seconds(nbytes) / secs, "%")
