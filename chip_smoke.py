"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernels, check
each against its plain PyTorch version, and run the Cornell, veach-mis and
San Miguel path-tracing passes and the microbenchmarks P1-P3.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, nvcc (CUDA_HOME or PATH), g++ and the repository
checkout; imports nothing of JAX. Each phase prints one JSON line, any
failure exits non-zero, and nothing falls back to the CPU:

1. the card's name and power limit; build every kernel (csrc/traversal8.cu:
   K1; csrc/traversal_tt.cu: K2, K3; csrc/traversal_pool.cu: K4;
   csrc/microbench.cu: P1-P3; and csrc/schedule_probe.cu, the designs the
   shared variants were measured against), one nvcc each, all started
   together, and print ptxas's registers, stack and spills; from
   cuobjdump's SASS, each traversal kernel's 128-bit loads: the shared
   variants of K1 and K2 must read rows with LDS (no generic LD), the
   global kernels with LDG;
2. K1's variants against its plain version on the Cornell 512^2 table with
   131,072+513 rays inside the box: the shared variant (the one the size
   rule picks), the global variant forced, and the two designs of
   utils/schedule_probe.py (the shared variant with rays by a static
   stride instead of the queue, and with its stacks in shared memory);
   closest-hit, any-hit and mixed any_mask (half the lanes
   any-hit). t, tri, u, v, step counts and flags must be identical (the
   kernels are built with -fmad=false, so both round op for op); each
   variant timed by the median of 5 synchronised runs and, mixed, by its
   device time (CUDA events queued behind a sleeping kernel, so the host's
   launch cost falls outside). K4 on the same rays in the same
   modes: identical to K1 and to the plain version, and again on the rays
   shuffled (results un-shuffled after);
3. PathTracer on Cornell 32^2, depth 4, 16 passes against
   tests/goldens/cornell_32_pt.npz (mean relative error < 0.02);
4. the Cornell headline: PathTracer on Cornell 512^2, max_depth 6, chunks
   of 65,536 lanes, 4 passes, through K1 alone, every launch shared;
4a. veach-mis (2,164 triangles, 331 rows): K1's variants, and K4 against K1
   and the plain version, on 65,536 camera rays plus 65,536 random rays, as
   in phase 2; the shared variant's prologue from the device times of both
   variants on one ray and on one dead ray per thread of a full grid;
4b. the veach anchor: veach_mis_anchor(48, 48), depth 8, rr_depth 4, NEE,
   256 spp as 16 passes of spp_per_pass=16, through K4 (pool=True); RMSE
   against the mean of tests/goldens/ref_veach.npz's two seeds under 2.5x
   their RMSE, the mean within test_rmse_anchor.py's bound and within 20%
   of the reference's (the JAX package's renders lie 10-16% under); pool=False
   (K1) gives the same film bit for bit;
4c. the veach-mis headline: 512^2, depth 5, chunks of 65,536 lanes, NEE
   with MIS, 8 passes per run after a warm-up pass, runs through K1, K4,
   K4, K1 (pool=False / True); counts zeroed around each run: K4 launches
   in the pool runs and K1 (all shared) in the others, and nothing else,
   0 plain calls,
   0 capped or overflowed rays, a finite non-black film;
5. the San Miguel stand-in at full width (1.2M triangles; host build
   seconds: native BVH, treelet partition) and 131,072 camera rays plus
   131,072 random rays from the courtyard, closest / any-hit / mixed:
   K1 (the global variant by the size rule; the shared one forced must be
   refused) identical to its plain version; then at both visit budgets the
   path runs (V=6 for camera rays, V=3 for the rest), K2's variants (as
   K1's in phase 2) and K3 identical to their plain versions (hits, visit
   lists, counts, min-dropped t, steps, flags), K1 on the exact path's
   fallback batch (tmax -1 on every ray whose visits did not overflow,
   mixed) identical to its plain version and timed, the two-phase result
   identical to the plain two-phase result,
   and the exact treelet path (K2 + K3 + K1 fallback) held to K1 on the
   unsplit table: t identical on every closest-hit lane, tri identical
   except on lanes where two triangles tie in t (counted and printed),
   hit/no-hit identical on any-hit lanes; medians of 5 synchronised runs of
   the treelet path, K1 and the plain two-phase path;
6. San Miguel 128^2, depth 5, 4 passes through the treelet path and again
   through K1 alone (the treelet tables dropped): mean relative error
   < 1e-3, K2 and K3 launched at both V in the first run and not at all
   in the second;
7. the slice's headline: San Miguel 1024^2, depth 5, chunks of 131,072
   lanes, 2 passes. The launch counts are zeroed just before and read just
   after; K1, and K2 and K3 at both V, must all launch (every K2 launch
   shared, every K1 launch global), no CUDA tensor may reach a plain
   version, and no ray may be capped or overflow. With
   --profile, one more pass runs under torch.profiler and its kernel table
   is printed, summed over each kernel's template instantiations (and in
   4c one more veach-mis pass through K1 and through K4);
8. P1-P3 (utils/microbench.py) timed at their full sizes, with the counts
   zeroed around the run; the output of every timed configuration must
   equal its plain version's on the same inputs.

The kernel table comes next: one row for each variant of K1 and K2 and
for each of K3, K4 and P1-P3, with its launches on its own path (the
global variant of K2 takes none on the main path), its time and its plain
version's time (K1 shared on veach-mis, K1 global on the San Miguel
fallback batch, K2 and K3 at V=3; the other shapes under by_scene, by_v,
fallback_by_v and mixed_rays; the forced global variant and the probe's
designs on the same rays beside K1's and K2's shared rows), and its bound: the larger of the bytes it must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s (traversal: the table once, the rays in and the
hits out; the measured steps times a node step's operations). Then the
card's name and power limit, and last the device record.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "goldens", "cornell_32_pt.npz")
N_RAYS = 131072 + 513
# K1's and K2's variants held to the plain versions on a table that fits
# shared memory: the one the size rule picks (None), the global variant
# forced, and the two designs the shared variant was measured against
# (utils/schedule_probe.DESIGNS)
K1_VARIANTS = (None, "global", "stride", "smem_stack")
SM_HALF = 131072
VEACH_HALF = 65536
REF_VEACH = os.path.join(HERE, "tests", "goldens", "ref_veach.npz")
CAL = 2.5   # tests/test_rmse_anchor.py's calibration of the noise floor
# the veach anchor's mean may lie at most this share under or over the
# reference's: the JAX package's own renders of the anchor (seeds 0-2, on
# the CPU) lie 10-16% under it, and the port's equal them
MEAN_GAP = 0.2
# device_ms's sleeping kernel: ~6 ms at the H100's 1.755 GHz, longer than
# the host takes to queue its calls
SLEEP_CYCLES = 10_000_000
# the traversal kernels' names in a profile, one entry per K2
# instantiation (template argument: V)
KERNEL_RE = re.compile(r"traverse8(?:_shared)?_kernel"
                       r"|top_visits(?:_shared)?_kernel(?:<\d+>)?"
                       r"|treelet_hits_kernel|traverse_pool_kernel")
# the kernels in a mangled SASS function name, and their template arguments
SASS_NAME_RE = re.compile(r"(traverse8_shared_kernel|traverse8_kernel"
                          r"|top_visits_shared_kernel|top_visits_kernel"
                          r"|treelet_hits_kernel|traverse_pool_kernel)"
                          r"(I(?:L[bi]\d+E)+E)?")
SASS_LOAD_RE = re.compile(r"\b(?:LDS|LDG|LD|LDGSTS)(?:\.[A-Z0-9_]+)*\b")


def emit(**kw):
    print(json.dumps(dict(kw, t=round(time.perf_counter() - T0, 1))), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_median_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, reps=10):
    """Device time of one call of `fn`: the median, over `reps` calls, of the
    time between CUDA events recorded around each call, all queued behind a
    sleeping kernel, so that the host's launch and synchronisation (which
    cuda_median_ms includes) fall outside them."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record()
    for k in range(reps):
        fn()
        ev[k + 1].record()
    torch.cuda.synchronize()
    return statistics.median(ev[k].elapsed_time(ev[k + 1]) for k in range(reps))


def sass_loads(lib_path, nvcc):
    """{kernel<template args>: {128-bit load opcode: count}} from the SASS
    of a built library (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = SASS_NAME_RE.search(ln)
            args = re.findall(r"L[bi](\d+)E", m.group(2) or "") if m else []
            fn = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else None
            if fn:
                out[fn] = {}
            continue
        if fn:
            for op in SASS_LOAD_RE.findall(ln):
                if "128" in op:
                    out[fn][op] = out[fn].get(op, 0) + 1
    return out


def check_variants(label, run, plain, modes, variants, bound=None, **info):
    """Each variant of a kernel against its plain version on the same inputs
    in each mode. run(variant, kw) and plain(kw) return (fields, steps,
    flags); every field must be identical and no lane flagged. Each variant
    is timed as a median of 5 synchronised runs (and, in the mixed mode, by
    its device time); the plain version in the mixed mode. Emits one line
    per mode and variant (None: the variant the size rule picks); returns
    {(mode, variant): dict(err, ms, device_ms, plain_ms, steps, bound)}."""
    out = {}
    for mode, kw in modes.items():
        ref = plain(kw)
        plain_ms = cuda_median_ms(lambda: plain(kw)) if mode == "mixed" else None
        for variant in variants:
            got = run(variant, kw)
            ok, err = same(got[0], ref[0])
            ms = cuda_median_ms(lambda: run(variant, kw))
            dms = device_ms(lambda: run(variant, kw)) if mode == "mixed" else None
            steps, flagged = int(got[1].sum()), int((got[2] != 0).sum())
            res = dict(err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                       steps=steps, bound=bound(steps) if bound else None)
            emit(phase="variant_vs_plain", kernel=label, mode=mode,
                 variant=variant or "auto", identical=ok, max_abs_err=err,
                 ms=ms, device_ms=dms, plain_ms=plain_ms, steps=steps,
                 flagged=flagged, bound_ms=res["bound"] and res["bound"][0],
                 **info)
            if not ok:
                fail(f"{label} ({variant or 'auto'}) disagrees with its plain "
                     f"version ({mode}, {info})")
            if flagged:
                fail(f"capped or overflowed lanes in {label} {mode} {info}")
            out[mode, variant] = res
    return out


def same(a, b):
    """(all identical, max abs difference over the finite entries of the
    float tensors) of two tuples of tensors; None entries are skipped."""
    pairs = [(x, y) for x, y in zip(a, b) if x is not None or y is not None]
    ok = all(torch.equal(x, y) for x, y in pairs)
    err = 0.0
    for x, y in pairs:
        if x.is_floating_point():
            m = torch.isfinite(x) & torch.isfinite(y)
            if bool(m.any()):
                err = max(err, float((x[m] - y[m]).abs().max()))
    return ok, err


def trav_bound(table, B, steps, mixed, mb, traversal8):
    """bound_ms of one traversal launch: the table once, the rays in (o, d,
    tmin, tmax; the any-hit mask when mixed) and the hits out (t, tri, u, v,
    steps, flags); the measured steps times a node step's operations (the
    cheaper step kind, so the bound stays a lower bound)."""
    n_bytes = table.numel() * 4 + B * (32 + int(mixed)) + B * 21
    return mb.bound_ms(n_bytes, steps * traversal8.NODE_STEP_FLOPS)


def check_pool(scene_name, table, rays, amask, K1, K4, traversal8, Rays, seed):
    """K4 against K1 and the plain version in the three modes, then on the
    rays shuffled and un-shuffled after; every field must be identical.
    Emits one line per mode; returns {mode: (err, k4 ms, k1 ms, plain ms,
    steps)}."""
    B = rays.o.shape[0]
    dev = table.device
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(B)).to(dev)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(B, device=dev)
    shuffled = Rays(*(x[perm].contiguous() for x in rays))
    out = {}
    modes = {"closest": ({}, {}), "any_hit": (dict(any_hit=True),) * 2,
             "mixed": (dict(any_mask=amask), dict(any_mask=amask[perm]))}
    for mode, (kw, kw_s) in modes.items():
        h4, s4, f4 = K4(table, rays, with_iters=True, **kw)
        h1, s1, f1 = K1(table, rays, with_iters=True, **kw)
        hp, sp, fp = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
        ok1, err1 = same((*h4, s4, f4), (*h1, s1, f1))
        okp, errp = same((*h4, s4, f4), (*hp, sp, fp))
        hs, ss, fs = K4(table, shuffled, with_iters=True, **kw_s)
        oks, errs = same(tuple(None if x is None else x[inv]
                               for x in (*hs, ss, fs)), (*h1, s1, f1))
        ms = (cuda_median_ms(lambda: K4(table, rays, **kw)),
              cuda_median_ms(lambda: K1(table, rays, **kw)),
              cuda_median_ms(lambda: traversal8.intersect_wide(table, rays, **kw)))
        flagged = int((f4 != 0).sum())
        emit(phase="kernel_vs_plain", scene=scene_name, kernel="K4", mode=mode,
             rays=B, rows=table.shape[0], identical_to_k1=ok1,
             identical_to_plain=okp, shuffled_identical=oks,
             max_abs_err=max(err1, errp, errs), ms=ms[0], k1_ms=ms[1],
             plain_ms=ms[2], steps=int(s4.sum()), min_steps=int(s4.min()),
             flagged=flagged, hit_rate=float((h4.tri >= 0).float().mean()))
        if not (ok1 and okp and oks):
            fail(f"K4 disagrees with K1 or the plain version ({scene_name}, {mode})")
        if flagged:
            fail(f"capped or overflowed rays in {scene_name} {mode}")
        out[mode] = (max(err1, errp, errs), *ms, int(s4.sum()))
    return out


def profile_pass(tr, scene_name, **extra):
    """One more pass of `tr` under torch.profiler: device time, busy share,
    event count, and the traversal kernels summed over their template
    instantiations."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.do_pass()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies, memsets): a CPU op's
    # device time would count its kernels a second time
    evs = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in evs)
    top_k = sorted(evs, key=lambda e: -e.self_device_time_total)[:20]
    trav = {}
    for e in evs:
        m = KERNEL_RE.search(e.key)
        if m:
            k = trav.setdefault(m.group(0), dict(count=0, ms=0.0))
            k["count"] += e.count
            k["ms"] += e.self_device_time_total / 1e3
    trav_ms = sum(k["ms"] for k in trav.values())
    emit(phase="profile", scene=scene_name, wall_s=wall, device_ms=total / 1e3,
         device_busy=total / 1e6 / wall, device_events=sum(e.count for e in evs),
         traversal_kernels=trav, traversal_ms=trav_ms,
         traversal_share=trav_ms / max(total / 1e3, 1e-9),
         top=[dict(name=e.key[:70], count=e.count,
                   ms=e.self_device_time_total / 1e3) for e in top_k], **extra)


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "cudatracerlib_tpu_torch")):
        fail("run from a checkout of the repository")
    from cudatracerlib_tpu_torch.models import film as filmmod
    from cudatracerlib_tpu_torch.models import path as pathmod
    from cudatracerlib_tpu_torch.models import tracer as tracermod
    from cudatracerlib_tpu_torch.ops import cuda_build, traversal8, traversal_tt
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.utils import example_scenes
    from cudatracerlib_tpu_torch.utils import microbench as mb
    from cudatracerlib_tpu_torch.utils import schedule_probe as probe

    profile = "--profile" in sys.argv[1:]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    emit(phase="card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    # the launch counters of the kernels and the traversals' plain versions
    K1, K2, K3 = (traversal8.intersect_wide_cuda, traversal_tt.top_visits_cuda,
                  traversal_tt.treelet_hits_cuda)
    K4 = traversal8.intersect_wide_pool_cuda
    plains = (traversal8.intersect_wide, traversal_tt.top_visits,
              traversal_tt.treelet_hits)

    def zero_counts():
        for f in (K1, K2, K3, K4, *mb.KERNELS):
            f.launches = 0
        for f in (K2, K3):
            f.launches_by_v = dict.fromkeys(f.launches_by_v, 0)
        for f in (K1, K2):
            f.launches_by_variant = dict.fromkeys(f.launches_by_variant, 0)
        for f in plains:
            f.cuda_calls = 0

    def k1_variants(label, table, rays, amask_, variants, only_mixed=False):
        """K1's variants against its plain version on `rays`: closest-hit,
        any-hit and mixed (any-hit where `amask_`), or only mixed."""
        modes_ = {"closest": {}, "any_hit": dict(any_hit=True),
                  "mixed": dict(any_mask=amask_)}
        if only_mixed:
            modes_ = {"mixed": modes_["mixed"]}

        def run(variant, kw):
            if variant in probe.DESIGNS:
                h, st, fl = probe.traverse8(table, rays, variant,
                                            with_iters=True, **kw)
            else:
                h, st, fl = K1(table, rays, with_iters=True, _variant=variant,
                               **kw)
            return (*h, st, fl), st, fl

        def plain(kw):
            h, st, fl = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
            return (*h, st, fl), st, fl
        return check_variants(
            "K1", run, plain, modes_, variants,
            bound=lambda steps: trav_bound(table, rays.o.shape[0], steps,
                                           True, mb, traversal8),
            scene=label, rays=rays.o.shape[0], rows=table.shape[0],
            shared_bytes=table.shape[0] * traversal8.ROW_BYTES,
            rule=traversal8.launch_variant(table))

    def plain_calls():
        return sum(f.cuda_calls for f in plains)

    # 1. build every kernel from the checkout's sources, in parallel
    t0 = time.perf_counter()
    sources = ("traversal8.cu", "traversal_tt.cu", "traversal_pool.cu",
               "microbench.cu", "schedule_probe.cu")
    cuda_build.build(*sources)
    build_s = time.perf_counter() - t0
    for src in sources:
        log = cuda_build.build_log[src]
        ptxas = [ln.strip() for ln in log["ptxas"].splitlines()
                 if "registers" in ln or "stack frame" in ln
                 or "Compiling entry" in ln]
        emit(phase="build", kernel=src, seconds=round(log["seconds"], 3),
             ptxas=ptxas)
    emit(phase="build", seconds_all=round(build_s, 3))
    # the shared variants must read their rows with LDS (not generic LD),
    # the global ones with LDG
    for src in ("traversal8.cu", "traversal_tt.cu", "traversal_pool.cu"):
        loads = sass_loads(cuda_build.build_log[src]["path"],
                           cuda_build.find_nvcc())
        for fn, ops in loads.items():
            shared_table = "_shared_" in fn
            emit(phase="sass", kernel=fn, loads_128=ops,
                 dynamic_shared_bytes="rows * 512" if shared_table else 0)
            lds = sum(n for op, n in ops.items() if op.startswith("LDS"))
            ldg = sum(n for op, n in ops.items() if op.startswith("LDG."))
            generic = sum(n for op, n in ops.items() if op.startswith("LD."))
            if (lds == 0 or generic) if shared_table else ldg == 0:
                fail(f"{fn}: unexpected row loads {ops}")

    # 2. K1 against its plain version at the Cornell path's ray count
    scene512 = example_scenes.cornell_box(512, 512).build(dev)
    table = scene512.geom.wide
    rng = np.random.default_rng(1234)
    o = rng.uniform(0.05, 0.95, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
                torch.full((N_RAYS,), 1e-4, device=dev),
                torch.full((N_RAYS,), 1e9, device=dev))
    amask = torch.from_numpy(rng.random(N_RAYS) < 0.5).to(dev)
    k1_cornell = k1_variants("cornell_box", table, rays, amask, K1_VARIANTS)
    check_pool("cornell_box", table, rays, amask, K1, K4, traversal8, Rays, 5)

    # 3. golden image on the card
    zero_counts()
    tr32 = pathmod.PathTracer(example_scenes.cornell_box(32, 32).build(dev),
                              32, 32, max_depth=4, spp_per_pass=1)
    img = tr32.render(16).cpu().numpy()
    ref = np.load(GOLDEN)["img"]
    rel = float(np.abs(img - ref).mean() / max(ref.mean(), 1e-6))
    emit(phase="golden", size=32, passes=16, rel_err=rel, limit=0.02,
         launches=K1.launches, plain_cuda_calls=plain_calls())
    if not rel < 0.02:
        fail(f"golden drift {rel}")
    if K1.launches <= 0 or plain_calls():
        fail("the golden pass did not run through the kernel alone")

    # 4. the Cornell headline: its path, with the counts zeroed around it
    tr = pathmod.PathTracer(scene512, 512, 512, max_depth=6, chunk_size=65536)
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = [], []
    for _ in range(4):
        before = tr.rays_traced_live
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        rays_n.append(tr.rays_traced_live - before)
    img = filmmod.develop(tr.film).cpu().numpy()
    launches, plain_n = K1.launches, plain_calls()
    k1_by_variant = {"cornell_box": dict(K1.launches_by_variant)}
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="cornell_box", size=512, max_depth=6,
         chunk_size=65536, passes=4, seconds_per_pass=statistics.median(secs),
         pass_seconds=secs, live_rays=int(sum(rays_n)),
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches=launches, launches_by_variant=k1_by_variant["cornell_box"],
         k2_launches=K2.launches, k3_launches=K3.launches,
         plain_cuda_calls=plain_n,
         mean_radiance=float(img.mean()), finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("headline image is not finite and non-black")
    if capped or overflowed:
        fail(f"capped {capped} / overflowed {overflowed} rays")
    if launches <= 0 or plain_n:
        fail("the headline pass did not run through the kernel alone")
    if K1.launches_by_variant["shared"] != launches:
        fail(f"Cornell K1 launches not all shared: {K1.launches_by_variant}")
    del tr, scene512

    # 4a. veach-mis: K4 against K1 and the plain version on its table
    veach = example_scenes.veach_mis(512, 512).build(dev)
    vtable = veach.geom.wide
    pix = (torch.arange(VEACH_HALF, dtype=torch.int32, device=dev) * 4) % (512 * 512)
    cam = tracermod.gen_camera_rays(veach, pix, 0, 0, 512, 512)[0]
    rng = np.random.default_rng(77)
    o = np.stack([rng.uniform(-4, 4, VEACH_HALF), rng.uniform(-1.9, 2.5, VEACH_HALF),
                  rng.uniform(-3, 5.5, VEACH_HALF)], 1).astype(np.float32)
    d = rng.normal(size=(VEACH_HALF, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 2 * VEACH_HALF
    v_rays = Rays(o=torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                  d=torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                  tmin=torch.full((B,), 1e-4, device=dev),
                  tmax=torch.full((B,), 1e30, device=dev))
    v_mask = torch.from_numpy(rng.random(B) < 0.5).to(dev)
    emit(phase="veach_build", tris=veach.num_tris, rows=vtable.shape[0],
         table_kb=vtable.numel() * 4 / 1024,
         bvh_seconds=veach.host["build_seconds"]["bvh"])
    k1_veach = k1_variants("veach_mis", vtable, v_rays, v_mask, K1_VARIANTS)
    k4_res = check_pool("veach_mis", vtable, v_rays, v_mask, K1, K4,
                        traversal8, Rays, 6)
    k4_bound = trav_bound(vtable, B, k4_res["mixed"][4], True, mb, traversal8)
    # the shared variant's prologue (staging the table), from its device
    # time against the global variant's: one ray (one block), and one dead
    # ray (tmax -1, one step) for every thread of a full grid
    n_full = torch.cuda.get_device_properties(dev).multi_processor_count \
        * traversal8.SHARED_THREADS
    one = Rays(*(x[:1].contiguous() for x in v_rays))
    dead = Rays(*(x[:n_full].contiguous() for x in v_rays[:3]),
                tmax=torch.full((n_full,), -1.0, device=dev))
    prologue = {}
    for name, rr in (("one_ray", one), ("dead_full_grid", dead)):
        prologue[name] = [dict(variant=v, device_ms=device_ms(
            lambda: K1(vtable, rr, _variant=v), reps=20))
            for v in ("shared", "global", "global", "shared")]
    emit(phase="prologue", scene="veach_mis", rows=vtable.shape[0],
         shared_bytes=vtable.shape[0] * traversal8.ROW_BYTES, dead_rays=n_full,
         runs=prologue)
    del v_rays, cam

    # 4b. the veach anchor against the independent reference render
    g = np.load(REF_VEACH)
    ref_a, ref_b = g["img"].astype(np.float64), g["img_seed2"].astype(np.float64)
    spp, aw, ah, adepth = (int(g[k]) for k in ("spp", "w", "h", "max_depth"))
    noise = float(np.sqrt(((ref_a - ref_b) ** 2).mean()))
    anchor = example_scenes.veach_mis_anchor(aw, ah).build(dev)
    films, anchor_runs = {}, {}
    for pool in (True, False):
        zero_counts()
        t0 = time.perf_counter()
        ta = pathmod.PathTracer(anchor, aw, ah, max_depth=adepth, rr_depth=4,
                                use_nee=True, spp_per_pass=16, pool=pool)
        ta.render_batched(spp // 16)
        films[pool] = ta.film
        anchor_runs["K4" if pool else "K1"] = dict(
            seconds=time.perf_counter() - t0, k1=K1.launches, k4=K4.launches,
            plain=plain_calls(), ovf=[int(x) for x in ta._ovf_dev.tolist()])
    got = filmmod.develop(films[True]).cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(((got - 0.5 * (ref_a + ref_b)) ** 2).mean()))
    mean_got, mean_ref = float(got.mean()), float(ref_a.mean())
    mean_bound = 0.05 * max(mean_ref, 1e-6) + 3.0 * noise
    mean_gap = abs(mean_got - mean_ref) / max(mean_ref, 1e-6)
    same_film = all(torch.equal(getattr(films[True], f), getattr(films[False], f))
                    for f in ("rgb", "weight"))
    emit(phase="veach_anchor", size=aw, spp=spp, passes=spp // 16,
         spp_per_pass=16, max_depth=adepth, rmse=rmse, noise_floor=noise,
         limit=CAL * noise, mean=mean_got, mean_ref=mean_ref,
         mean_bound=mean_bound, mean_gap=mean_gap, mean_gap_limit=MEAN_GAP,
         pool_film_identical=same_film, runs=anchor_runs)
    if not (rmse < CAL * noise and abs(mean_got - mean_ref) < mean_bound
            and mean_gap < MEAN_GAP):
        fail(f"veach anchor: RMSE {rmse} vs {CAL} x {noise}, mean {mean_got} vs {mean_ref}")
    if not same_film:
        fail("the veach anchor's film differs between K4 and K1")
    if (anchor_runs["K4"]["k4"] <= 0 or anchor_runs["K4"]["k1"]
            or anchor_runs["K1"]["k1"] <= 0 or anchor_runs["K1"]["k4"]
            or anchor_runs["K4"]["plain"] or anchor_runs["K1"]["plain"]):
        fail(f"the anchor runs took the wrong kernels: {anchor_runs}")
    del anchor, films

    # 4c. the veach-mis headline: K1 and K4 in turns, after a warm-up pass
    vtr = {pool: pathmod.PathTracer(veach, 512, 512, max_depth=5,
                                    chunk_size=65536, pool=pool)
           for pool in (False, True)}
    for t in vtr.values():
        t.do_pass()
    k4_launches = 0
    for pool in (False, True, True, False):
        t = vtr[pool]
        torch.cuda.synchronize()
        zero_counts()
        secs, rays_n = [], []
        for _ in range(8):
            before = t.rays_traced_live
            t.do_pass()
            secs.append(t.last_pass_seconds)
            rays_n.append(t.rays_traced_live - before)
        counts = dict(K1=K1.launches, K4=K4.launches, K2=K2.launches,
                      K3=K3.launches, plain=plain_calls(),
                      K1_by_variant=dict(K1.launches_by_variant))
        k4_launches += counts["K4"]
        if not pool:
            by_v = k1_by_variant.setdefault(
                "veach_mis", dict.fromkeys(traversal8.VARIANTS, 0))
            for v, n in K1.launches_by_variant.items():
                by_v[v] += n
            if K1.launches_by_variant["shared"] != K1.launches:
                fail(f"veach-mis K1 launches not all shared: "
                     f"{K1.launches_by_variant}")
        emit(phase="headline", scene="veach_mis", tris=veach.num_tris, size=512,
             max_depth=5, chunk_size=65536, passes=8, pool=pool,
             kernel="K4" if pool else "K1",
             seconds_per_pass=statistics.median(secs), pass_seconds=secs,
             live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
             launches=counts)
        want, other = ("K4", "K1") if pool else ("K1", "K4")
        if (counts[want] <= 0 or counts[other] or counts["K2"] or counts["K3"]
                or counts["plain"]):
            fail(f"the veach-mis {want} run took the wrong kernels: {counts}")
    for pool, t in vtr.items():
        img = filmmod.develop(t.film).cpu().numpy()
        capped, overflowed = (int(x) for x in t._ovf_dev.tolist())
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail("the veach-mis image is not finite and non-black")
        if capped or overflowed:
            fail(f"veach-mis: capped {capped} / overflowed {overflowed} rays")
    if profile:
        for pool, t in vtr.items():
            profile_pass(t, "veach_mis", kernel="K4" if pool else "K1")
    same_film = torch.equal(vtr[False].film.rgb, vtr[True].film.rgb)
    emit(phase="veach_films", passes=17 + int(profile), k1_k4_identical=same_film,
         steps=int(vtr[True]._iters_dev), capped=0, overflowed=0,
         mean_radiance=float(img.mean()))
    if not same_film:
        fail("the veach-mis films of K1 and K4 differ")
    del vtr, veach

    # 5. San Miguel at full width: host build, then K2, K3 and K1 on its tables
    t0 = time.perf_counter()
    sm = example_scenes.san_miguel_stand_in(1024, 1024)
    gen_s = time.perf_counter() - t0
    scene = sm.build(dev)
    torch.cuda.synchronize()
    geom = scene.geom
    top, slabs, wide = geom.tt_top, geom.tt_slabs, geom.wide
    emit(phase="sm_build", tris=scene.num_tris, rows=wide.shape[0],
         table_mb=wide.numel() * 4 / 2**20, top_rows=top.shape[0],
         treelets=slabs.shape[0], slab_rows=slabs.shape[1],
         slabs_mb=slabs.numel() * 4 / 2**20, visit_ids=geom.tt_vid.shape[0],
         shade_mb=geom.shade.numel() * 4 / 2**20,
         texels=scene.textures.texels.shape[0],
         generate_seconds=gen_s,
         build_seconds=time.perf_counter() - t0 - gen_s,
         bvh_seconds=scene.host["build_seconds"]["bvh"],
         treelet_seconds=scene.host["build_seconds"]["treelet"])

    pix = (torch.arange(SM_HALF, dtype=torch.int32, device=dev) * 8) % (1024 * 1024)
    cam = tracermod.gen_camera_rays(scene, pix, 0, 0, 1024, 1024)[0]
    rng = np.random.default_rng(99)
    o = np.stack([rng.uniform(-16, 16, SM_HALF), rng.uniform(0.3, 5.0, SM_HALF),
                  rng.uniform(-10, 10, SM_HALF)], 1).astype(np.float32)
    d = rng.normal(size=(SM_HALF, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    B = 2 * SM_HALF
    sm_rays = Rays(o=torch.cat([cam.o, torch.from_numpy(o).to(dev)]),
                   d=torch.cat([cam.d, torch.from_numpy(d).to(dev)]),
                   tmin=torch.full((B,), 1e-4, device=dev),
                   tmax=torch.full((B,), 1e30, device=dev))
    sm_mask = torch.from_numpy(rng.random(B) < 0.5).to(dev)
    sm_modes = {"closest": {}, "any_hit": dict(any_hit=True),
                "mixed": dict(any_mask=sm_mask)}
    # K1 on the unsplit table: the global variant by the size rule; the
    # shared variant forced there must be refused, not fall back
    kernel_ms = {}
    k1_sm = k1_variants("san_miguel_stand_in", wide, sm_rays, sm_mask, (None,))
    k1_res = {mode: K1(wide, sm_rays, **kw) for mode, kw in sm_modes.items()}
    try:
        K1(wide, sm_rays, _variant="shared")
    except RuntimeError as e:
        emit(phase="refused", kernel="K1", variant="shared", rows=wide.shape[0],
             shared_bytes=wide.shape[0] * traversal8.ROW_BYTES, error=str(e))
    else:
        fail("K1's shared variant on the San Miguel table was not refused")
    k2_res = {}
    for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT):
        def k2_run(variant, kw):
            if variant in probe.DESIGNS:
                r = probe.top_visits(top, sm_rays, V, variant, **kw)
            else:
                r = K2(top, sm_rays, V, _variant=variant, **kw)
            return (*r[0], *r[1:]), r[5], r[6]

        def k2_plain(kw):
            r = traversal_tt.top_visits(top, sm_rays, V, **kw)
            return (*r[0], *r[1:]), r[5], r[6]
        # K2 reads the top table and the rays and writes the hits, V visits
        # (id, entry t), the count and the min-dropped t
        k2_res[V] = check_variants(
            "K2", k2_run, k2_plain, sm_modes, K1_VARIANTS,
            bound=lambda steps: mb.bound_ms(
                top.numel() * 4 + B * 33 + B * (29 + 8 * V),
                steps * traversal8.NODE_STEP_FLOPS),
            scene="san_miguel_stand_in", V=V, rays=B, rows=top.shape[0],
            shared_bytes=top.shape[0] * traversal8.ROW_BYTES,
            rule=traversal8.launch_variant(top))
        for mode, kw in sm_modes.items():
            h1 = k1_res[mode]
            any_lane = traversal8.any_lanes(B, kw.get("any_hit", False),
                                            kw.get("any_mask"), dev)
            k2 = K2(top, sm_rays, V, **kw)
            _, keys, order, t_prune = traversal_tt.visit_slots(
                k2[0], k2[1], k2[3], slabs.shape[0], any_lane)
            k3 = K3(slabs, sm_rays, t_prune, keys, order, V, **kw)
            p3 = traversal_tt.treelet_hits(slabs, sm_rays, t_prune, keys, order,
                                           V, **kw)
            ok3, err3 = same((*k3[0], *k3[1:]), (*p3[0], *p3[1:]))
            tk = traversal_tt.two_phase(K2, K3, top, slabs, sm_rays, V=V,
                                        with_overflow=True, with_iters=True, **kw)
            tp = traversal_tt.two_phase(traversal_tt.top_visits,
                                        traversal_tt.treelet_hits, top, slabs,
                                        sm_rays, V=V, with_overflow=True,
                                        with_iters=True, **kw)
            okt, errt = same((*tk[0], tk[1], tk[2], tk[4]),
                             (*tp[0], tp[1], tp[2], tp[4]))
            coherent = V == traversal8.V_COHERENT
            ex, ex_iters, _, ex_flags = traversal8.intersect_treelet_exact(
                geom, sm_rays, coherent=coherent, with_iters=True, **kw)
            # the exact treelet path against K1 on the unsplit table
            cl = ~any_lane
            t_same = bool(torch.equal(ex.t[cl], h1.t[cl]))
            ties = int((cl & (ex.tri != h1.tri)).sum())
            hit_same = bool(torch.equal((ex.tri >= 0)[any_lane],
                                        (h1.tri >= 0)[any_lane]))
            total, dropped = (int(x) for x in traversal_tt.count_dropped_visits(
                top, sm_rays, V)) if mode == "closest" else (None, None)
            vcnt = k2[3]
            times = dict(
                treelet_ms=cuda_median_ms(lambda: traversal8.intersect_treelet_exact(
                    geom, sm_rays, coherent=coherent, **kw)),
                two_phase_ms=cuda_median_ms(lambda: traversal_tt.two_phase(
                    K2, K3, top, slabs, sm_rays, V=V, **kw)),
                k1_ms=k1_sm[mode, None]["ms"],
                plain_ms=cuda_median_ms(lambda: traversal_tt.two_phase(
                    traversal_tt.top_visits, traversal_tt.treelet_hits, top,
                    slabs, sm_rays, V=V, **kw)))
            if mode == "mixed":
                # K3 reads the slabs, the rays, the prune t and the B*V keys
                # and slots, and writes one hit per slot
                kernel_ms["K3", V] = (err3, cuda_median_ms(lambda: K3(
                    slabs, sm_rays, t_prune, keys, order, V, **kw)),
                    cuda_median_ms(lambda: traversal_tt.treelet_hits(
                        slabs, sm_rays, t_prune, keys, order, V, **kw)),
                    mb.bound_ms(slabs.numel() * 4 + B * 33 + B * V * 29,
                                int(k3[1].sum()) * traversal8.NODE_STEP_FLOPS))
                # K1 on the exact path's fallback batch: every lane whose
                # visits did not overflow has tmax -1 and takes one step
                fb = Rays(sm_rays.o, sm_rays.d, sm_rays.tmin,
                          torch.where(tk[1], tk[0].t, -1.0))
                kernel_ms["K1_fallback", V] = k1_variants(
                    f"san_miguel_fallback_V{V}", wide, fb, sm_mask, (None,),
                    only_mixed=True)["mixed", None]
            emit(phase="sm_kernels_vs_plain", mode=mode, rays=B, V=V,
                 k3_identical=ok3, two_phase_identical=okt,
                 max_abs_err=max(err3, errt),
                 visits=int(vcnt.sum()), visits_kept=int(vcnt.clamp_max(V).sum()),
                 dropped_visits=int((vcnt - V).clamp_min(0).sum()),
                 count_dropped_visits=[total, dropped],
                 fallback_rays=int(tk[1].sum()), treelet_steps=int(ex_iters),
                 flags=[int(x) for x in ex_flags.tolist()],
                 exact_t_identical=t_same, tri_ties=ties,
                 any_hit_lanes_identical=hit_same, **times)
            if not (ok3 and okt):
                fail(f"K3 or the two-phase path disagrees with its plain "
                     f"version ({mode}, V={V})")
            if not (t_same and hit_same):
                fail(f"the treelet path disagrees with K1 beyond t-ties "
                     f"({mode}, V={V})")
            if int(ex_flags.sum()):
                fail(f"capped or overflowed rays on San Miguel ({mode}, V={V})")
    del sm_rays, cam

    # 6. San Miguel 128^2 through the treelet path, then through K1 alone
    scene128 = scene._replace(
        sensor=example_scenes.san_miguel_stand_in(128, 128).sensor_data(dev))
    flat128 = scene128._replace(geom=geom._replace(tt_top=None, tt_slabs=None,
                                                   tt_vid=None))
    imgs, counts = [], []
    for sc in (scene128, flat128):
        zero_counts()
        t128 = pathmod.PathTracer(sc, 128, 128, max_depth=5)
        imgs.append(t128.render(4).cpu().numpy())
        counts.append(dict(k1=K1.launches, k2=K2.launches, k3=K3.launches,
                           k2_by_v=dict(K2.launches_by_v),
                           k3_by_v=dict(K3.launches_by_v), plain=plain_calls(),
                           ovf=[int(x) for x in t128._ovf_dev.tolist()]))
    rel = float(np.abs(imgs[0] - imgs[1]).mean() / max(imgs[1].mean(), 1e-6))
    emit(phase="sm_image", size=128, max_depth=5, passes=4, rel_err=rel,
         limit=1e-3, treelet_run=counts[0], k1_only_run=counts[1],
         mean_radiance=float(imgs[0].mean()))
    if not rel < 1e-3:
        fail(f"treelet and K1-only San Miguel images differ: {rel}")
    by_v = (*counts[0]["k2_by_v"].values(), *counts[0]["k3_by_v"].values())
    if (min(by_v) <= 0 or counts[1]["k2"]
            or counts[1]["k3"] or counts[1]["k1"] <= 0
            or counts[0]["plain"] or counts[1]["plain"]):
        fail(f"the 128^2 runs took the wrong kernels: {counts}")
    del scene128, flat128

    # 7. the slice's headline: its path, with the counts zeroed around it
    tr = pathmod.PathTracer(scene, 1024, 1024, max_depth=5, chunk_size=131072)
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = [], []
    for _ in range(2):
        before = tr.rays_traced_live
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        rays_n.append(tr.rays_traced_live - before)
    launches = {"K1": K1.launches}
    for name, f in (("K2", K2), ("K3", K3)):
        launches.update({(name, V): n for V, n in f.launches_by_v.items()})
    sm_by_variant = dict(K1=dict(K1.launches_by_variant),
                         K2=dict(K2.launches_by_variant))
    plain_n = plain_calls()
    img = filmmod.develop(tr.film).cpu().numpy()
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="san_miguel_stand_in", tris=scene.num_tris,
         size=1024, max_depth=5, chunk_size=131072, passes=2,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches={k if isinstance(k, str) else f"{k[0]}_V{k[1]}": n
                   for k, n in launches.items()},
         launches_by_variant=sm_by_variant, plain_cuda_calls=plain_n,
         mean_radiance=float(img.mean()), finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("San Miguel image is not finite and non-black")
    if capped or overflowed:
        fail(f"capped {capped} / overflowed {overflowed} rays")
    if min(launches.values()) <= 0 or plain_n or K4.launches:
        fail(f"the San Miguel pass did not run through K1, and K2 and K3 at "
             f"both V, alone: {launches}, {plain_n} plain calls, "
             f"{K4.launches} K4 launches")
    # the top table fits shared memory, the unsplit table does not
    if (sm_by_variant["K2"]["shared"] != K2.launches
            or sm_by_variant["K1"]["global"] != K1.launches):
        fail(f"San Miguel launches by variant: {sm_by_variant}")

    if profile:
        profile_pass(tr, "san_miguel_stand_in")

    # 8. P1-P3 at full size, each held to its plain version on its inputs
    torch.cuda.synchronize()
    zero_counts()
    res = mb.measure(dev)
    mb_launches = dict(P1=mb.chase_rows_cuda.launches,
                       P2=mb.gather_rows_cuda.launches + mb.loop_only_cuda.launches,
                       P3=mb.queue_fetch_cuda.launches)
    emit(phase="microbench", nvidia_smi=card, launches=mb_launches,
         max_abs_err=mb.max_abs_err(res), **res)
    if min(mb_launches.values()) <= 0:
        fail(f"a microbenchmark kernel did not launch: {mb_launches}")
    if mb.max_abs_err(res) != 0:
        fail("a microbenchmark kernel disagrees with its plain version")

    # the kernel table: one row for each variant of K1 and K2, timed at the
    # main path's shapes: K1 shared on veach-mis (Cornell under by_scene),
    # K1 global on the San Miguel fallback batch at V=3 (the whole
    # 262,144-ray traversal under mixed_rays); K2 and K3 at V=3 (80 of their
    # 96 launches per headline), with both budgets under by_v
    def row(name, src, replaces, launches_n, err, ms, plain_ms, bound, **extra):
        return dict(name=name, route="cuda",
                    source=f"cudatracerlib_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=launches_n, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                    bound_by=bound[1], library_ms=None, **extra)

    def max_err(res, variant):
        return max(r["err"] for (_, v), r in res.items() if v == variant)

    def brief(r):
        return dict(ms=r["ms"], device_ms=r["device_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound"][0])

    def vrow(name, src, replaces, launches_n, err, r, **extra):
        return row(name, src, replaces, launches_n, err, r["ms"], r["plain_ms"],
                   r["bound"], device_ms=r["device_ms"], **extra)

    def tt_row(kname, name, src, replaces):
        by_v = {f"V{V}": dict(launches=launches[kname, V], ms=kernel_ms[kname, V][1],
                              plain_ms=kernel_ms[kname, V][2],
                              bound_ms=kernel_ms[kname, V][3][0])
                for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)}
        k = (kname, traversal8.V_INCOHERENT)
        return row(name, src, replaces,
                   sum(launches[kname, V] for V in (traversal8.V_COHERENT,
                                                    traversal8.V_INCOHERENT)),
                   max(kernel_ms[kname, V][0] for V in (traversal8.V_COHERENT,
                                                        traversal8.V_INCOHERENT)),
                   *kernel_ms[k][1:], by_v=by_v)

    def k2_row(name, variant):
        by_v = {f"V{V}": dict(launches=launches["K2", V] if variant is None else 0,
                              **brief(k2_res[V]["mixed", variant]))
                for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)}
        return vrow(name, "traversal_tt.cu",
                    "cudatracerlib_tpu/ops/traversal_tt.py:185",
                    sm_by_variant["K2"][variant or "shared"],
                    max(max_err(k2_res[V], variant) for V in k2_res),
                    k2_res[traversal8.V_INCOHERENT]["mixed", variant],
                    variant=variant or "shared", by_v=by_v,
                    designs={d: {f"V{V}": brief(k2_res[V]["mixed", d])
                                 for V in k2_res} for d in probe.DESIGNS}
                    if variant is None else None)

    k1_shared_n = sum(k1_by_variant[sc]["shared"] for sc in k1_by_variant)
    k1_rows = [
        vrow("traverse8_shared_kernel", "traversal8.cu",
             "cudatracerlib_tpu/ops/traversal_pl.py:188", k1_shared_n,
             max(max_err(k1_cornell, None), max_err(k1_veach, None)),
             k1_veach["mixed", None], variant="shared",
             by_scene={sc: dict(launches=k1_by_variant[sc]["shared"],
                                **brief(res["mixed", None]),
                                global_variant=brief(res["mixed", "global"]),
                                designs={d: brief(res["mixed", d])
                                         for d in probe.DESIGNS})
                       for sc, res in (("cornell_box", k1_cornell),
                                       ("veach_mis", k1_veach))}),
        vrow("traverse8_kernel", "traversal8.cu",
             "cudatracerlib_tpu/ops/traversal_pl.py:188",
             sm_by_variant["K1"]["global"],
             max(max_err(k1_sm, None), *(r["err"] for k, r in kernel_ms.items()
                                         if k[0] == "K1_fallback")),
             kernel_ms["K1_fallback", traversal8.V_INCOHERENT], variant="global",
             fallback_by_v={f"V{V}": brief(kernel_ms["K1_fallback", V])
                            for V in (traversal8.V_COHERENT, traversal8.V_INCOHERENT)},
             mixed_rays=brief(k1_sm["mixed", None]))]
    def mb_row(entry):
        return (entry["max_abs_err"], entry["ms"], entry["plain_ms"],
                (entry["bound_ms"], entry["bound_by"]))

    p1 = next(e for e in res["P1"] if e["rows"] == mb.ROW_TABLE_ROWS
              and e["memory"] == "global")
    p2 = next(e for e in res["P2"] if e["rows"] == mb.ROW_TABLE_ROWS
              and e["layout"] == "thread")
    p3 = next(e for e in res["P3"] if e["items"] == mb.ROW_QUEUE_ITEMS)
    emit(kernels=[
        *k1_rows,
        k2_row("top_visits_shared_kernel", None),
        k2_row("top_visits_kernel", "global"),
        tt_row("K3", "treelet_hits_kernel", "traversal_tt.cu",
               "cudatracerlib_tpu/ops/traversal_tt.py:340"),
        row("traverse_pool_kernel", "traversal_pool.cu",
            "cudatracerlib_tpu/ops/traversal_pl.py:298", k4_launches,
            k4_res["mixed"][0], k4_res["mixed"][1], k4_res["mixed"][3],
            k4_bound),
        row("chase_rows_kernel", "microbench.cu",
            "tools/microbench_r2.py:89", mb_launches["P1"], *mb_row(p1)),
        row("gather_rows_thread_kernel", "microbench.cu",
            "tools/microbench_r2c.py:46", mb_launches["P2"], *mb_row(p2)),
        row("queue_fetch_kernel", "microbench.cu",
            "tools/probe_mosaic_pool.py:40", mb_launches["P3"], *mb_row(p3))])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
