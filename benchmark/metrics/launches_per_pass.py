"""CUDA kernels launched per pass: the kernel events of the traced passes
in the profiler's trace, over the passes traced."""


def read(run):
    n = run.summary.kernel_launches()
    return (n / run.passes, "launches/pass") if n else None
