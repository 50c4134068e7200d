"""Microbenchmarks of the traversal kernels' building blocks on the card:
P1, P2 and P3 (``csrc/microbench.cu``).

They replace the JAX package's TPU microbenchmarks and Mosaic probes
(``tools/microbench_r2.py``, ``tools/microbench_r2c.py``,
``tools/probe_mosaic_pool.py``) and ask the questions that bound the
traversal kernels K1-K4 on Hopper:

- P1 ``chase_rows``: the latency of a dependent 512-byte row fetch, of
  the whole row or of the 14 float4 a traversal's node step reads
  (``NODE_WORDS``), in the ways the traversal kernels read a row
  (``CHASE_MODES``): one thread
  through L1/L2 ("thread"), from the block's shared memory ("shared"), 16
  lanes a row coalesced ("group", K1's group design), through a cluster's
  distributed shared memory ("cluster", K2's cluster design), and by a
  bulk copy into shared memory ("bulk", TMA); at two occupancies
  (``OCCUPANCIES``: 1,024 chains, and one chain a warp on every SM for the
  latency alone), each the slope of two step counts, so that the launch
  and the staging fall out. ``floor_entry`` picks the reading a
  traversal's chain floor takes (a node step's read from the nearest
  memory its rows can lie in, so that the floor is a lower bound);
- P2 ``gather_rows``: the throughput of independent row gathers in K1's
  thread-per-row layout and a coalesced warp-per-row layout; and
  ``loop_only``, the cost of a loop step by itself;
- P3 ``queue_fetch``: the cost of K4's warp queue fetch per item, and that
  it hands out every item exactly once.

Each kernel wrapper (``*_cuda``, with a ``launches`` counter) takes CUDA
tensors only and has a plain PyTorch version beside it (the name without
``_cuda``), which the CPU tests hold to numpy loops and ``chip_smoke.py``
holds the kernel to. ``measure`` times them on the card and holds each
output to its plain version's on the same inputs.

A row's value is the xor of its 128 32-bit words; after step s a chain
goes to row ((that xor + s * 0x9E3779B9) mod 2^32) mod the row count, so
it does not close into a short cycle of cached rows.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops import cuda_build, traversal8
from .schedule_probe import slab_variant

Tensor = torch.Tensor

ROW_BYTES = 512
PEAK_BYTES_PER_S = 3.35e12    # H100 SXM device memory (data sheet)
PEAK_FLOPS_F32 = 67e12        # H100 SXM float32 outside the tensor cores
# the TPU microbenchmarks' table sizes, then Cornell's, veach-mis's, the
# 4.8M-triangle San Miguel stand-in's top table and the 1.2M-triangle
# stand-in's whole table (108 MB, past the 50 MB L2)
TABLE_ROWS = (256, 1024, 4096, 317, 331, 998, 211592)
CHAINS, CHAIN_STEPS = 1024, 256        # P1's B and steps (and twice them)
# float4 a P1 step reads from the start of its row: the whole row, or what
# a traversal's node step reads (its boxes and links: the cheaper step
# kind, so a floor from it stays a lower bound)
ROW_WORDS, NODE_WORDS = 32, 14
# P1's modes (the C entry's codes) and the (mode, param, words) runs
# measure() times: G = 16 lanes a chain (K1's group design), clusters of
# 2, 4 and 8 blocks (K2's cluster design takes 2, 4 or 8); the whole row in
# every mode, a node step's read in the modes a chain floor takes
CHASE_MODES = {"thread": 0, "shared": 1, "group": 2, "cluster": 3, "bulk": 4}
GROUP_LANES = (8, 16, 32)
CLUSTER_BLOCKS = (1, 2, 4, 8)
_FLOOR_RUNS = (("thread", None), ("shared", None), ("group", 16), ("cluster", 2),
               ("cluster", 4), ("cluster", 8))
CHASE_RUNS = (tuple((m, p, ROW_WORDS) for m, p in _FLOOR_RUNS + (("bulk", None),))
              + tuple((m, p, NODE_WORDS) for m, p in _FLOOR_RUNS))
CHASE_THREADS = 128                    # a block's threads (the kernels' cap)
# the two occupancies: "chains" runs CHAINS chains in blocks of
# CHASE_THREADS, the kernel table's row shape; "warp" one chain a warp, one
# warp a block, a block for every SM: the latency alone
OCCUPANCIES = ("chains", "warp")
# the P1 reading a traversal design's rows are held to (its chain floor):
# the mode whose read the design makes, and its parameter (None: any); the
# split design's staged rows (``split_floor`` holds the rest to "thread")
DESIGN_READS = {"thread": ("thread", None), "group": ("group", 16),
                "shared": ("shared", None), "cluster": ("cluster", None),
                "global": ("thread", None), "split": ("shared", None)}
GATHERS = 1 << 20                      # P2's independent gathers per launch
LOOP_LANES, LOOP_STEPS = 1024, 65536
QUEUE_ITEMS = (65536, 131072, 262144)  # the path's merged wavefront sizes
LOOP_FACTOR = 1.000001
CHAIN_MIX = 0x9E3779B9
# the configuration of each kernel's row in chip_smoke.py's kernel table:
# veach-mis's table, and its merged wavefront (two chunks of 65,536 lanes)
ROW_TABLE_ROWS, ROW_QUEUE_ITEMS = 331, 131072


def bound_ms(n_bytes: float, n_ops: float):
    """(least milliseconds the card could take, "bytes" or "operations"):
    the larger of the bytes over the device memory rate and the float32
    operations over the peak float32 rate (published H100 SXM peaks)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- plain versions

def _row_xor(rows: Tensor) -> Tensor:
    """(N, W) float32 rows -> (N,) int64 xor of each row's 32-bit words,
    as an unsigned value."""
    w = rows.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    width = 1 << (w.shape[1] - 1).bit_length()
    w = torch.nn.functional.pad(w, (0, width - w.shape[1]))   # xor with 0
    while w.shape[1] > 1:
        half = w.shape[1] // 2
        w = w[:, :half] ^ w[:, half:]
    return w[:, 0]


def _as_int32(u: Tensor) -> Tensor:
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def chase_rows(table: Tensor, idx0: Tensor, n_steps: int,
               seen: Tensor = None, words: int = ROW_WORDS) -> Tensor:
    """P1's plain version: (C,) int32 last row of each chain, each step
    reading the first `words` float4 of its row. Every mode computes it.
    `seen`, a (rows,) bool tensor, marks each row a chain reads."""
    n_rows = table.shape[0]
    idx = idx0.to(torch.int64)
    for s in range(n_steps):
        if seen is not None:
            seen[idx] = True
        idx = ((_row_xor(table[idx, :4 * words]) + s * CHAIN_MIX) & 0xFFFFFFFF) \
            % n_rows
    return idx.to(torch.int32)


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """P2's plain version: (N,) int32 xor of row idx[i]'s words."""
    return _as_int32(_row_xor(table[idx.to(torch.int64)]))


def loop_only(x0: Tensor, n_steps: int) -> Tensor:
    """P2's empty loop: x = x * 1.000001 + 1, n_steps times (float32)."""
    x = x0.clone()
    for _ in range(n_steps):
        x = x * LOOP_FACTOR + 1.0
    return x


def queue_fetch(n: int, n_warps: int = 4, device="cpu") -> Tensor:
    """P3's plain version: the warp queue played in rounds, every warp in
    turn claiming one item for each of its 32 lanes from the shared counter
    until a claim reaches past the queue. Returns (n,) int32 counts of how
    often each item was handed out."""
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    lanes = torch.arange(32 * n_warps, device=device)
    counter = 0
    while counter < n:
        ids = counter + lanes
        counts.index_add_(0, ids[ids < n], torch.ones_like(ids[ids < n],
                                                           dtype=torch.int32))
        counter += 32 * n_warps
    return counts


# --------------------------------------------------------------- kernel wrappers

def _lib():
    lib = cuda_build.load_library("microbench.cu")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ctl_chase_rows.argtypes = [vp, ci, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp]
    lib.ctl_gather_rows.argtypes = [vp, vp, ci, ci, vp, vp]
    lib.ctl_loop_only.argtypes = [vp, ci, ci, vp, vp]
    lib.ctl_queue_fetch.argtypes = [ci, vp, vp, vp]
    for fn in (lib.ctl_chase_rows, lib.ctl_gather_rows, lib.ctl_loop_only,
               lib.ctl_queue_fetch):
        fn.restype = ci
    return lib


def _check(x: Tensor, name: str, dtype, shape):
    if not (isinstance(x, Tensor) and x.is_cuda):
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)}, got {x.dtype} {tuple(x.shape)}")


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: error {err}")


def _p(x: Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _check_table(table: Tensor):
    _check(table, "table", torch.float32, (table.shape[0], 128))
    if table.shape[0] == 0 or table.data_ptr() % 16:
        raise ValueError("table must be non-empty and 16-byte aligned")


def check_chase(mode: str, param, lanes: int, threads: int, n_rows: int,
                shared_limit: int, words: int = ROW_WORDS):
    """(param, lanes) of a P1 launch in `mode` (``CHASE_MODES``) on a table
    of `n_rows` rows, the defaults filled in (group: G = 16 lanes a chain;
    cluster: the fewest blocks whose shares fit, ``schedule_probe.slab_variant``;
    lanes: G for group, else 1), on a card whose blocks may opt in to
    `shared_limit` bytes of shared memory. Raises ValueError, as the C
    entry refuses: another mode, G or blocks count; lanes not a power of
    two up to 32 or under G; threads not a multiple of 32 up to
    CHASE_THREADS; words other than ROW_WORDS and NODE_WORDS; a table
    (shared) or a block's share of it (cluster) that does not fit a
    block."""
    if words not in (ROW_WORDS, NODE_WORDS):
        raise ValueError(f"a P1 step reads {ROW_WORDS} or {NODE_WORDS} float4, "
                         f"not {words}")
    if mode not in CHASE_MODES:
        raise ValueError(f"no P1 mode {mode!r}: one of {list(CHASE_MODES)}")
    if mode == "group":
        param = 16 if param is None else param
        if param not in GROUP_LANES:
            raise ValueError(f"a group reads a row with {GROUP_LANES} lanes, not {param}")
    elif mode == "cluster":
        param = slab_variant(n_rows, shared_limit) if param is None else param
        if param not in CLUSTER_BLOCKS:
            raise ValueError(f"no cluster of {CLUSTER_BLOCKS} blocks holds {n_rows} rows"
                             if param == 0 else
                             f"a cluster has {CLUSTER_BLOCKS} blocks, not {param}")
    else:
        param = 0
    lanes = (param if mode == "group" else 1) if lanes is None else lanes
    if not (1 <= lanes <= 32 and lanes & (lanes - 1) == 0) \
            or (mode == "group" and lanes < param):
        raise ValueError(f"{lanes} lanes a chain: a power of two up to 32, "
                         f"at least the group's {param}")
    if threads % 32 or not 32 <= threads <= CHASE_THREADS:
        raise ValueError(f"{threads} threads a block: a multiple of 32 up to "
                         f"{CHASE_THREADS}")
    share = -(-n_rows // (param if mode == "cluster" else 1)) * ROW_BYTES
    if mode in ("shared", "cluster") and share > shared_limit:
        raise ValueError(f"{n_rows} rows do not fit shared memory in mode {mode}"
                         + (f" over {param} blocks" if mode == "cluster" else ""))
    return param, lanes


def chase_rows_cuda(table: Tensor, idx0: Tensor, n_steps: int,
                    mode: str = "thread", param: int = None, lanes: int = None,
                    threads: int = CHASE_THREADS, words: int = ROW_WORDS) -> Tensor:
    """P1 on the card in `mode` with `param`, `lanes` threads a chain,
    blocks of `threads` and `words` float4 read a step (``check_chase``,
    which fills the defaults and raises on what the kernel does not take;
    ``chase_rows`` with the same `words` is its plain version). Each
    launch adds one to
    ``chase_rows_cuda.launches`` and to
    ``chase_rows_cuda.launches_by_mode[mode]``."""
    _check_table(table)
    _check(idx0, "idx0", torch.int32, (idx0.shape[0],))
    param, lanes = check_chase(mode, param, lanes, threads, table.shape[0],
                               traversal8._shared_limit(table.device.index), words)
    out = torch.empty_like(idx0)
    _raise_on(_lib().ctl_chase_rows(_p(table), table.shape[0], _p(idx0),
                                    idx0.shape[0], n_steps, CHASE_MODES[mode],
                                    param, lanes, threads, words, _p(out),
                                    _stream(table.device)),
              "chase_rows")
    chase_rows_cuda.launches += 1
    chase_rows_cuda.launches_by_mode[mode] += 1
    return out


chase_rows_cuda.launches = 0
chase_rows_cuda.launches_by_mode = dict.fromkeys(CHASE_MODES, 0)


def gather_rows_cuda(table: Tensor, idx: Tensor, warp: bool = False) -> Tensor:
    """P2's row gather on the card: thread-per-row, or with `warp`
    warp-per-row."""
    _check_table(table)
    _check(idx, "idx", torch.int32, (idx.shape[0],))
    out = torch.empty_like(idx)
    _raise_on(_lib().ctl_gather_rows(_p(table), _p(idx), idx.shape[0],
                                     int(warp), _p(out), _stream(table.device)),
              "gather_rows")
    gather_rows_cuda.launches += 1
    return out


gather_rows_cuda.launches = 0


def loop_only_cuda(x0: Tensor, n_steps: int) -> Tensor:
    _check(x0, "x0", torch.float32, (x0.shape[0],))
    out = torch.empty_like(x0)
    _raise_on(_lib().ctl_loop_only(_p(x0), x0.shape[0], n_steps, _p(out),
                                   _stream(x0.device)), "loop_only")
    loop_only_cuda.launches += 1
    return out


loop_only_cuda.launches = 0


def queue_fetch_cuda(n: int, device="cuda") -> Tensor:
    """P3 on the card: (n,) int32 counts, each 1 when the queue is right."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("queue_fetch_cuda runs on a CUDA device")
    counts = torch.zeros(n, dtype=torch.int32, device=device)
    counter = torch.empty(1, dtype=torch.int32, device=device)
    _raise_on(_lib().ctl_queue_fetch(n, _p(counter), _p(counts),
                                     _stream(device)), "queue_fetch")
    queue_fetch_cuda.launches += 1
    return counts


queue_fetch_cuda.launches = 0
KERNELS = (chase_rows_cuda, gather_rows_cuda, loop_only_cuda, queue_fetch_cuda)


# --------------------------------------------------------------- on the card

def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds per call of `fn` on the current stream: CUDA events
    around `reps` calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _random_table(n_rows: int, gen: torch.Generator, dev) -> Tensor:
    """Random 32-bit words viewed as float32 (only their bits are used)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (n_rows, 128), generator=gen,
                         dtype=torch.int32, device=dev).view(torch.float32)


def _random_idx(n: int, n_rows: int, gen: torch.Generator, dev) -> Tensor:
    return torch.randint(0, n_rows, (n,), generator=gen, dtype=torch.int32,
                         device=dev)


def _timed(fn, reps: int = 10):
    """(ms per call of `fn`, by event_ms; the output of its last call)."""
    out = [None]

    def call():
        out[0] = fn()
    return event_ms(call, reps=reps), out[0]


def _diff(got: Tensor, ref: Tensor) -> float:
    return float((got.double() - ref.double()).abs().max())


def _occupancy(occupancy: str, lanes: int, sms: int):
    """(chains, lanes a chain, threads a block) of a P1 run at `occupancy`
    (``OCCUPANCIES``) in a mode whose chain takes `lanes` lanes."""
    if occupancy == "chains":
        return CHAINS, lanes, CHASE_THREADS
    return sms, 32, 32


def chase_entries(table: Tensor, gen: torch.Generator, sms: int,
                  runs=CHASE_RUNS, reps: int = 10) -> list:
    """P1 on `table` in each (mode, param, words) of `runs` that fits it,
    at both occupancies: each timed with CUDA events at CHAIN_STEPS and
    twice that (ms per launch), ns per dependent row the slope between the
    two (the launch and any staging fall out), its bound (the distinct
    rows' `words` float4 read once; a step's xors), and `max_abs_err` of
    both outputs against the plain version on the same chains."""
    n_rows, dev = table.shape[0], table.device
    limit = traversal8._shared_limit(dev.index)
    out = []
    for occupancy in OCCUPANCIES:
        chains = _occupancy(occupancy, 1, sms)[0]
        idx0 = _random_idx(chains, n_rows, gen, dev)
        refs, distinct = {}, {}
        for words in sorted({w for _, _, w in runs}):
            seen = torch.zeros(n_rows, dtype=torch.bool, device=dev)
            for n in (CHAIN_STEPS, 2 * CHAIN_STEPS):
                refs[n, words] = chase_rows(table, idx0, n,
                                            seen if n == CHAIN_STEPS else None, words)
            distinct[words] = int(seen.sum())
        for mode, param, words in runs:
            try:
                param, lanes = check_chase(mode, param, None, CHASE_THREADS, n_rows,
                                           limit, words)
            except ValueError:
                continue    # the table does not fit this mode
            chains, lanes, threads = _occupancy(occupancy, lanes, sms)
            ms, err = {}, 0.0
            for n in (CHAIN_STEPS, 2 * CHAIN_STEPS):
                ms[n], got = _timed(lambda: chase_rows_cuda(
                    table, idx0, n, mode, param, lanes, threads, words), reps=reps)
                err = max(err, _diff(got, refs[n, words]))
            b, by = bound_ms(distinct[words] * words * 16 + chains * 8,
                             chains * CHAIN_STEPS * (4 * words + 3))
            out.append(dict(
                rows=n_rows, mode=mode, param=param, words=words, occupancy=occupancy,
                chains=chains, lanes=lanes, threads=threads, steps=CHAIN_STEPS,
                ms=ms[CHAIN_STEPS], ms_twice_the_steps=ms[2 * CHAIN_STEPS],
                ns_per_dependent_row=(ms[2 * CHAIN_STEPS] - ms[CHAIN_STEPS])
                * 1e6 / CHAIN_STEPS,
                ns_per_dependent_fetch=ms[CHAIN_STEPS] * 1e6 / CHAIN_STEPS,
                distinct_rows=distinct[words], bound_ms=b, bound_by=by,
                max_abs_err=err))
    return out


def floor_entry(entries, design: str, rows: int, param: int = None,
                occupancy: str = "warp", words: int = NODE_WORDS):
    """The P1 entry a traversal design's chain floor takes (its steps times
    the entry's ``ns_per_dependent_row``): a node step's read (`words`
    float4) in the mode of the design's read (``DESIGN_READS``; a
    cluster's blocks `param` where that was measured, else any), at
    `occupancy` (one chain a warp: the latency alone), the lowest over the
    measured tables of at most `rows` rows (the smallest measured one
    where none is that small). A traversal keeps its hot rows in the
    nearest cache, so the table that caches best, not one of the call's
    own size, keeps the floor a lower bound. None when the mode was not
    measured."""
    mode, want = DESIGN_READS[design]
    want = param if want is None else want
    cand = [e for e in entries if e["mode"] == mode and e["occupancy"] == occupancy
            and e.get("words", ROW_WORDS) == words]
    if want is not None and any(e["param"] == want for e in cand):
        cand = [e for e in cand if e["param"] == want]
    if not cand:
        return None
    most = max(rows, min(e["rows"] for e in cand))
    return min((e for e in cand if e["rows"] <= most),
               key=lambda e: e["ns_per_dependent_row"])


def split_floor(entries, rows: int, near_far):
    """(ms, (near entry, far entry)) of the split design's chain floor on a
    top table of `rows` rows: the most, over `near_far` ((steps on the
    rows it stages, steps on the rest) of each of a call's lanes, or of
    each distinct pair), of the staged steps at floor_entry's shared
    reading and the others at its thread reading; (None, None) when either
    mode was not measured."""
    near, far = floor_entry(entries, "shared", rows), floor_entry(entries, "thread", rows)
    if near is None or far is None or not len(near_far):
        return None, None
    a, b = (max(e["ns_per_dependent_row"], 0.0) for e in (near, far))
    return max(n * a + f * b for n, f in near_far) / 1e6, (near, far)


def measure(device, seed: int = 1, table_rows=TABLE_ROWS, gathers: int = GATHERS,
            loop_steps: int = LOOP_STEPS, queue_items=QUEUE_ITEMS,
            chase_runs=CHASE_RUNS) -> dict:
    """P1-P3 timed with CUDA events (ms per launch), each entry with its
    bound and its `max_abs_err`: the largest difference between the output
    of the kernel's timed launches and its plain version's on the same
    inputs (0 when right; P3's plain counts are all ones). Every launch
    here is a timed one. P1 runs every run of `chase_runs` that fits each
    table at both occupancies (``chase_entries``). The entries of the
    kernel table's rows (ROW_TABLE_ROWS: P1 in mode thread, whole rows, at
    1,024 chains; ROW_QUEUE_ITEMS) also time the plain version. The sizes
    default to the module constants; a smaller call checks the kernels
    quickly."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p1, p2 = [], []
    for n_rows in table_rows:
        table = _random_table(n_rows, gen, dev)
        p1 += chase_entries(table, gen, sms, chase_runs)
        if n_rows == ROW_TABLE_ROWS:
            idx0 = _random_idx(CHAINS, n_rows, gen, dev)
            next(e for e in p1 if e["rows"] == n_rows and e["mode"] == "thread"
                 and e["words"] == ROW_WORDS and e["occupancy"] == "chains")["plain_ms"] = event_ms(
                lambda: chase_rows(table, idx0, CHAIN_STEPS), reps=3, warmup=1)
        idx = _random_idx(gathers, n_rows, gen, dev)
        ref = gather_rows(table, idx)
        for warp in (False, True):
            ms, got = _timed(lambda: gather_rows_cuda(table, idx, warp=warp))
            b, by = bound_ms(n_rows * ROW_BYTES + gathers * 8, gathers * 128)
            p2.append(dict(rows=n_rows, layout="warp" if warp else "thread",
                           gathers=gathers, ms=ms,
                           rows_gbps=gathers * ROW_BYTES / (ms * 1e-3) / 1e9,
                           bound_ms=b, bound_by=by, max_abs_err=_diff(got, ref)))
            if n_rows == ROW_TABLE_ROWS and not warp:
                p2[-1]["plain_ms"] = event_ms(lambda: gather_rows(table, idx),
                                              reps=3, warmup=1)
        del table, ref
    x0 = torch.rand(LOOP_LANES, generator=gen, device=dev)
    ms, got = _timed(lambda: loop_only_cuda(x0, loop_steps), reps=5)
    loop = dict(lanes=LOOP_LANES, steps=loop_steps, ms=ms,
                ns_per_step=ms * 1e6 / loop_steps,
                max_abs_err=_diff(got, loop_only(x0, loop_steps)))
    p3 = []
    for n in queue_items:
        runs = []
        ms = event_ms(lambda: runs.append(queue_fetch_cuda(n, dev)))
        ref = queue_fetch(n, 1024, dev)
        b, by = bound_ms(n * 4, n)
        p3.append(dict(items=n, ms=ms, ns_per_item=ms * 1e6 / n, launches=len(runs),
                       bound_ms=b, bound_by=by,
                       max_abs_err=max(_diff(c, ref) for c in runs)))
        if n == ROW_QUEUE_ITEMS:
            p3[-1]["plain_ms"] = event_ms(lambda: queue_fetch(n, 1024, dev),
                                          reps=3, warmup=1)
    return dict(P1=p1, P2=p2, loop_only=loop, P3=p3)


def max_abs_err(res: dict) -> float:
    """The largest `max_abs_err` of the entries of a `measure` result."""
    return max(e["max_abs_err"]
               for e in (*res["P1"], *res["P2"], res["loop_only"], *res["P3"]))
