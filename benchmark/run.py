"""Run one benchmark cell once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``): load the port's traversal kernels (built
only by the first run in a checkout), make the configuration's frozen
scene, build it on the card with the port's ``DynamicScene.build``, make
the traffic mix's tracer and run one warm-up pass. Then passes run back to
back through ``TracerBase.do_pass()`` for ``--seconds`` (a closed loop,
one pass in flight). ``--trace 1`` profiles the first passes of the
window and reports the per-layer metrics; ``--trace 0`` reports the
end-to-end ones. After the window the plain reference
(``benchmark/reference``) judges what the passes produced. The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cudatracerlib_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the per-layer metric readers see of a traced run."""

    def __init__(self, summary, passes, counters0, counters1, host_reads, table_bytes,
                 build_s):
        self.summary = summary
        self.passes = passes
        self.counters0 = counters0
        self.counters1 = counters1
        self.host_reads = host_reads
        self.table_bytes = table_bytes
        self.build_s = build_s

    def delta(self, key):
        if key in self.counters0 and key in self.counters1:
            return self.counters1[key] - self.counters0[key]
        return None


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None, overrides: dict = None) -> dict:
    """One run of a cell. Returns the result dict (without printing).
    `device` is "cuda" for a measurement; "cpu", with `overrides` that
    shrink the configuration and traffic ({"config": {...}, "traffic":
    {...}}), serves the rehearsal tests only, whose numbers are no device
    metrics."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import cells, port, trace as tracemod
    from .reference import judge

    cell = cells.load_cell(cell_name)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        with record_function("bench.kernel_load"):
            port.load_kernels()
    with record_function("bench.scene_make"):
        desc = cells.make_scene(cell.config)
    with record_function("bench.scene_build"):
        scene = port.build_scene(desc, dev)
    with record_function("bench.tracer"):
        tracer = port.make_tracer(scene, desc, cell.traffic, seed)
    judge_state = judge.Recorder(cell, tracer)
    with record_function("bench.warmup"):
        tracer.do_pass()
    judge_state.after_warmup(tracer)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    spp = int(getattr(tracer, "spp_per_pass", 1))
    frame_s, host_reads = [], []
    summary = counters0 = counters1 = None
    n_traced = int(cell.traffic.get("trace_passes", 2)) if trace else 0
    w0 = time.perf_counter()
    last_end = w0
    while True:
        if n_traced and not frame_s:
            counters0 = port.counters(tracer)
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts, record_shapes=True)
            prof.start()
        t0 = time.perf_counter()
        with record_function("bench.pass"):
            tracer.do_pass()
        last_end = time.perf_counter()
        frame_s.append(last_end - t0)
        if len(frame_s) <= n_traced and hasattr(tracer, "last_pass_host_reads"):
            host_reads.append(tracer.last_pass_host_reads)
        if n_traced and len(frame_s) == n_traced:
            prof.stop()
            counters1 = port.counters(tracer)
        if last_end - w0 >= seconds and len(frame_s) >= max(n_traced, 1):
            break
    window_s = last_end - w0
    mem_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if n_traced:
        summary = tracemod.summarize(prof)
        del prof

    metrics, breakdown = {}, None
    if trace:
        run = Run(summary, n_traced, counters0, counters1, host_reads,
                  port.traversal_table_bytes(scene), port.build_seconds(scene))
        for name in cells.metric_names():
            value = cells.metric_reader(name)(run)
            if value is not None:
                metrics[name] = {"value": value[0], "unit": value[1]}
        breakdown = tracemod.breakdown(summary)
    else:
        e2e = cell.workload["end_to_end"]
        if "spp_per_s" in e2e:
            metrics["spp_per_s"] = {"value": len(frame_s) * spp / window_s, "unit": "spp/s"}
        if "frame_p95_ms" in e2e:
            p95 = (statistics.quantiles(frame_s, n=100, method="inclusive")[94]
                   if len(frame_s) > 1 else frame_s[0])
            metrics["frame_p95_ms"] = {"value": p95 * 1e3, "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    # the judgement runs once the window has closed and the peak is read,
    # on what the timed passes produced, with the program's state freed
    produced = judge_state.produced(tracer)
    del tracer, scene
    if cuda:
        torch.cuda.empty_cache()
    checks = judge.judge(cell, desc, produced, seed, dev)
    correct = judge.is_correct(checks)

    result = {"correct": correct, "attempted": len(frame_s), "failed": 0,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                         "count": 1, "memory_peak_bytes": int(mem_peak)}}
    if trace:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(f"window {window_s:.3f} s, {len(frame_s)} passes, median pass "
          f"{statistics.median(frame_s):.4f} s, set-up {setup_s:.3f} s", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # any kernel cache a library keeps goes to a fixed place in the checkout
    # (the port builds its own kernels under its package's _build/)
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")

    import torch
    from . import cells
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      t_start=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print("benchmark: forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
