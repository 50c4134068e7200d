"""Reduce a torch.profiler trace, kept in memory, to what the per-layer
metrics and the breakdown read: device intervals by kernel name, device
busy time within the traced window, the gather ops with the device time of
the kernels each launched, and the idle gaps named by what the host was
doing (the benchmark's ``bench.*`` spans and the innermost op)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass

GATHER_OPS = ("aten::index", "aten::index_select", "aten::gather")
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict            # kernel name -> [count, device seconds]
    copies: dict             # memcpy / memset name -> [count, device seconds]
    gathers: list            # (op name, bytes out + index bytes, device seconds)
    idle_gaps: dict          # host activity -> idle seconds

    def kernel_launches(self) -> int:
        return int(sum(c for c, _ in self.kernels.values()))

    def kernel_seconds(self, substrings) -> float:
        return float(sum(s for name, (_, s) in self.kernels.items()
                         if any(k in name for k in substrings)))


def _union_length(iv):
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(iv):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, cur_s


def _gaps(iv, t0, t1):
    """Idle intervals of [t0, t1] not covered by the device intervals."""
    out, cur = [], t0
    for s, e in sorted(iv):
        if s > cur:
            out.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        out.append((cur, t1))
    return [(a, b) for a, b in out if b > a]


def _gather_bytes(ev, children):
    """Bytes a gather must move at least: its output and its indices, once.
    aten::index records no index shapes, so its output shape is read from
    the restrided view (aten::as_strided) it makes of its input."""
    name, shapes = ev.name(), ev.shapes()
    dtype_bytes = {"float": 4, "int": 4, "long int": 8, "double": 8, "c10::Half": 2,
                   "c10::BFloat16": 2, "bool": 1, "unsigned char": 1, "signed char": 1,
                   "short int": 2}
    elem = dtype_bytes.get(ev.dtypes()[0] if ev.dtypes() else "float", 4)
    if not shapes or not shapes[0]:
        return 0
    row = 1
    for s in shapes[0][1:]:
        row *= s
    if name == "aten::index_select" and len(shapes) > 2 and shapes[2]:
        n = 1
        for s in shapes[2]:
            n *= s
        return n * row * elem + n * 8
    if name == "aten::gather" and len(shapes) > 2 and shapes[2]:
        n = 1
        for s in shapes[2]:
            n *= s
        return n * elem + n * 8
    for c in children:
        if c.name() == "aten::as_strided":
            conc = c.concrete_inputs()
            if len(conc) > 1 and isinstance(conc[1], (list, tuple)) and conc[1]:
                out_elems = 1
                for s in conc[1]:
                    out_elems *= int(s)
                return out_elems * elem + (out_elems // max(row, 1)) * 8
    return 0


def summarize(prof) -> Summary:
    """Reduce a finished torch.profiler.profile (record_shapes=True). The
    traced window runs from the start of the first ``bench.pass`` span to
    the end of the last."""
    events = prof.profiler.kineto_results.events()
    dev, host, launches = [], [], []
    for ev in events:
        s, d = ev.start_ns(), ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            # the device track also carries the record_function spans
            if not (getattr(ev, "is_user_annotation", lambda: False)()
                    or ev.name().startswith("bench.")):
                dev.append((s, s + d, ev.name(), ev.correlation_id()))
            continue
        name = ev.name()
        if name.startswith(LAUNCH_PREFIXES):
            launches.append((s, ev.correlation_id(), ev.start_thread_id()))
        elif name.startswith(("bench.", "aten::", "cuda")):
            host.append((s, s + d, name, ev))
    passes = [(s, e, ev.start_thread_id()) for s, e, n, ev in host if n == "bench.pass"]
    if not passes:
        raise RuntimeError("the trace holds no bench.pass span")
    t0, t1 = min(p[0] for p in passes), max(p[1] for p in passes)
    main = passes[0][2]

    dev_iv, by_corr = [], defaultdict(float)
    kernels, copies = defaultdict(lambda: [0, 0.0]), defaultdict(lambda: [0, 0.0])
    for s, e, name, corr in dev:
        if e < t0 or s > t1:
            continue
        dev_iv.append((max(s, t0), min(e, t1)))
        bucket = copies if name.startswith(("Memcpy", "Memset")) else kernels
        bucket[name][0] += 1
        bucket[name][1] += (e - s) * 1e-9
        by_corr[corr] += (e - s) * 1e-9
    busy_ns, _ = _union_length(dev_iv)

    host = [h for h in host if h[3].start_thread_id() == main and h[1] >= t0 and h[0] <= t1]
    host.sort(key=lambda x: (x[0], -x[1]))

    # gathers: the kernels each gather op launched, found by time nesting
    launches = sorted(l for l in launches if l[2] == main)
    l_starts = [l[0] for l in launches]
    starts = [h[0] for h in host]
    gathers = []
    for i, (s, e, name, ev) in enumerate(host):
        if name not in GATHER_OPS:
            continue
        j = bisect.bisect_right(starts, e)
        children = [h[3] for h in host[i + 1:j] if h[1] <= e]
        a, b = bisect.bisect_left(l_starts, s), bisect.bisect_right(l_starts, e)
        secs = sum(by_corr.get(launches[k][1], 0.0) for k in range(a, b))
        if secs > 0:
            gathers.append((name, _gather_bytes(ev, children), secs))

    # idle gaps, named by the innermost bench span and op open at their middle
    idle = defaultdict(float)
    stack, k = [], 0
    for a, b in _gaps(dev_iv, t0, t1):
        mid = (a + b) // 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        span = next((h[2] for h in reversed(stack) if h[2].startswith("bench.")), "host")
        op = stack[-1][2] if stack and not stack[-1][2].startswith("bench.") else None
        idle[f"{span}/{op}" if op else span] += (b - a) * 1e-9
    return Summary(window_s=(t1 - t0) * 1e-9, busy_s=busy_ns * 1e-9,
                   kernels=dict(kernels), copies=dict(copies), gathers=gathers,
                   idle_gaps=dict(idle))


def breakdown(summary: Summary, n: int = 10) -> dict:
    ops = {**{k: v[1] for k, v in summary.kernels.items()},
           **{k: v[1] for k, v in summary.copies.items()}}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(summary.idle_gaps.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in top],
            "idle_gaps": [[k[:200], v] for k, v in gaps]}
