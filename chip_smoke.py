"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernels, check
each against its plain PyTorch version, and run the Cornell, veach-mis and
San Miguel path-tracing passes, the PrimTracer, BDPT and light-tracer
passes and the microbenchmarks P1-P3.

    python3 chip_smoke.py [--profile]

Needs one CUDA device, nvcc (CUDA_HOME or PATH), g++ and the repository
checkout; imports nothing of JAX. Each phase prints one JSON line, any
failure exits non-zero, and nothing falls back to the CPU:

1. the card's name and power limit; build every kernel (csrc/traversal8.cu:
   K1; csrc/traversal_tt.cu: K2, K3; csrc/traversal_pool.cu: K4;
   csrc/microbench.cu: P1-P3; and csrc/schedule_probe.cu, the designs the
   shared variants of K1 and K2, and K3, were measured against), one nvcc
   each, all started together, and print ptxas's registers, stack and
   spills; from cuobjdump's SASS, each traversal kernel's 128-bit loads:
   the shared variants of K1 and K2 must read rows with LDS (no generic
   LD), the global kernels with LDG, and the probe's K3 designs that stage
   a slab must stage with LDGSTS and hold at least one step's row loads
   (K3's LDG count) as LDS or generic LD (through a cluster's shared
   windows);
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
   shuffled (results un-shuffled after); timed as K1's variants;
3. PathTracer on Cornell 32^2, depth 4, 16 passes against
   tests/goldens/cornell_32_pt.npz (mean relative error < 0.02);
4. the Cornell headline: PathTracer on Cornell 512^2, max_depth 6, chunks
   of 65,536 lanes, 4 passes, through K1 alone, every launch shared;
4a. veach-mis (2,164 triangles, 331 rows): K1's variants, and K4 against K1
   and the plain version, on 65,536 camera rays plus 65,536 random rays, as
   in phase 2; the shared variant's prologue from the device times of both
   variants on one ray and on one dead ray per thread of a full grid;
4b. the veach anchor: veach_mis_anchor(48, 48), depth 8, rr_depth 4, NEE,
   256 spp as 16 passes of spp_per_pass=16, through K1; RMSE against the
   mean of tests/goldens/ref_veach.npz's two seeds under 2.5x their RMSE,
   the mean within test_rmse_anchor.py's bound and within 20% of the
   reference's (the JAX package's renders lie 10-16% under);
4c. the veach-mis headline: 512^2, depth 5, chunks of 65,536 lanes, NEE
   with MIS, 8 passes after a warm-up pass, counts zeroed around them: K1
   (all shared) and nothing else, 0 plain calls, 0 capped or overflowed
   rays, a finite non-black film;
4d-4f. the light-path slice (light_path_phases): the PrimTracer headline
   (Cornell 512^2, shading normals), the BDPT and light-tracer headlines
   (the glass Cornell box 256^2, depth 6) with K1's launches per pass by
   mode held to the count worked out from the code, one pass of each
   profiled and one pass of each (PrimTracer's too) recorded and held,
   traversal by traversal, to K1's plain version; the card's BDPT and
   light-tracer images against their goldens, and all three against the
   CPU's, pass by pass;
5. the San Miguel stand-in at full width (1.2M triangles; host build
   seconds: native BVH, treelet partition) and 131,072 camera rays plus
   131,072 random rays from the courtyard, closest / any-hit / mixed:
   K1 (the global variant by the size rule; the shared one forced must be
   refused) identical to its plain version; then at both visit budgets the
   path runs (V=6 for camera rays, V=3 for the rest), K2's variants (as
   K1's in phase 2), and K3 and the probe's three K3 designs (cluster,
   split, walk), identical to their plain versions (hits, visit lists,
   counts, min-dropped t, steps, flags) and timed as K1's; on the mixed
   slots, the probe's cluster and walk designs at each chunk size and
   staging threshold of K3_CHUNKS x K3_MIN_STAGES (identical, the
   staged-segment count equal to the plain model's,
   schedule_probe.treelet_segments, and the device time), the cluster and
   split designs staging only (device
   time), and the probe's split of the slots (segments, staged count
   against the model, visits per staged segment, the share of valid
   visits left unstaged); K1 on the exact path's
   fallback batch (tmax -1 on every ray whose visits did not overflow,
   mixed) identical to its plain version and timed, and K4 on the same
   batch against K1 and the plain version as in phase 2 (K4 is on no
   render path; this sizes up its per-lane refill where few lanes of a
   warp are live), the two-phase result identical to the plain two-phase
   result,
   and the exact treelet path (K2 + K3 + K1 fallback) held to K1 on the
   unsplit table: t identical on every closest-hit lane, tri identical
   except on lanes where two triangles tie in t (counted and printed),
   hit/no-hit identical on any-hit lanes; medians of 5 synchronised runs of
   the treelet path, K1 and the plain two-phase path;
6. San Miguel 128^2, depth 5, 4 passes through the treelet path and again
   through K1 alone (the treelet tables dropped): mean relative error
   < 1e-3, K2 and K3 launched at both V in the first run and not at all
   in the second;
7. the San Miguel headline: San Miguel 1024^2, depth 5, chunks of 131,072
   lanes, 2 passes. The launch counts are zeroed just before and read just
   after; K1, and K2 and K3 at both V, must all launch (every K2 launch
   shared, every K1 launch global), no CUDA tensor may reach a plain
   version, and no ray may be capped or overflow. With
   --profile, one more pass runs under torch.profiler and its kernel table
   is printed, summed over each kernel's template instantiations (and in
   4c one more veach-mis pass; the BDPT and light-tracer passes of 4e are
   profiled in every run);
8. P1-P3 (utils/microbench.py) timed at their full sizes, with the counts
   zeroed around the run; the output of every timed configuration must
   equal its plain version's on the same inputs.

The kernel table comes next: one row for each variant of K1 and K2, for
K3 and each of the probe's K3 designs, and for K4 and P1-P3, with its
launches on its own path (the global variant of K2 and the K3 designs
take none on the main path, nor does K4), its time and its plain
version's time (K1 shared on veach-mis, K1 global on the San Miguel
fallback batch, K2 and K3 at V=3, K4 on veach-mis; the other shapes under
by_scene, by_tracer (one BDPT and one light-tracer pass, summed by mode),
by_v, fallback_by_v and mixed_rays; the forced global variant and the
probe's designs on the same rays beside K1's and K2's shared rows; the
probe's split of the slots beside its cluster design), its device time
where taken, and its bound:
the larger of the bytes it must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s (traversal: the table once, for K3 each slab a
valid visit names, the rays in and the hits out; the measured steps times
a node step's operations). Then the card's name and power limit, and last
the device record.
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
# K3's designs held to its plain version on the San Miguel slots: the kept
# kernel (None) and the three of utils/schedule_probe.K3_DESIGNS
K3_DESIGNS = (None, "cluster", "split", "walk")
# the probe's cluster and walk designs at other chunk sizes and staging
# thresholds (1 << 30: never staged), beside the probe's own (CHUNK,
# MIN_STAGE)
K3_CHUNKS = (1024, 4096, 16384)
K3_MIN_STAGES = (64, 256, 1024, 1 << 30)
SM_HALF = 131072
VEACH_HALF = 65536
REF_VEACH = os.path.join(HERE, "tests", "goldens", "ref_veach.npz")
CAL = 2.5   # tests/test_rmse_anchor.py's calibration of the noise floor
# the veach anchor's mean may lie at most this share under or over the
# reference's: the JAX package's own renders of the anchor (seeds 0-2, on
# the CPU) lie 10-16% under it, and the port's equal them
MEAN_GAP = 0.2
# the light-path slice's headlines: PrimTracer passes timed after the
# warm-up; BDPT and light-tracer depth and timed passes (bench.py's config 4)
PRIM_PASSES = 20
LP_DEPTH = 6
LP_PASSES = 4
# the card's renders against the CPU's on the same inputs: passes of BDPT
# and the light tracer (each pass draws a fresh RNG stream), and the limit
# on the mean relative error of every cumulative image, PrimTracer's too:
# the card's images lay 2.5e-8 to 1.8e-7 from the CPU's and the goldens
# (H100 80GB HBM3), the splats' atomic adds and the card's transcendental
# functions rounding a last bit differently
CARD_CPU_PASSES = 6
CARD_CPU_LIMIT = 1e-5
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
# K3's probe designs in a mangled name: the blocks of a cluster and where
# the staged slab lives
PROBE_K3_RE = re.compile(r"probe_treelet_kernelILi(\d)EN\w*?(Cluster|Split|Walk)Stage")
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
            m, p = SASS_NAME_RE.search(ln), PROBE_K3_RE.search(ln)
            args = re.findall(r"L[bi](\d+)E", m.group(2) or "") if m else []
            fn = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else None
            if p:
                fn = f"probe_treelet_kernel<{p.group(2).lower()},{p.group(1)}>"
            if fn:
                out[fn] = {}
            continue
        if fn:
            for op in SASS_LOAD_RE.findall(ln):
                if "128" in op:
                    out[fn][op] = out[fn].get(op, 0) + 1
    return out


def check_variants(label, run, plain, modes, variants, bound=None,
                   timed=("mixed",), plain_reps=5, **info):
    """Each variant of a kernel against its plain version on the same inputs
    in each mode. run(variant, kw) and plain(kw) return (fields, steps,
    flags); every field must be identical and no lane flagged. Each variant
    is timed as a median of 5 synchronised runs (and, in the modes of
    `timed`, by its device time); the plain version in the modes of `timed`,
    as a median of `plain_reps` runs. Emits one line per mode and variant
    (None: the variant the size rule picks); returns {(mode, variant):
    dict(err, ms, device_ms, plain_ms, steps, bound)}."""
    out = {}
    for mode, kw in modes.items():
        ref = plain(kw)
        plain_ms = (cuda_median_ms(lambda: plain(kw), reps=plain_reps)
                    if mode in timed else None)
        for variant in variants:
            got = run(variant, kw)
            ok, err = same(got[0], ref[0])
            ms = cuda_median_ms(lambda: run(variant, kw))
            dms = device_ms(lambda: run(variant, kw)) if mode in timed else None
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
        dms = device_ms(lambda: K4(table, rays, **kw)) if mode == "mixed" else None
        flagged = int((f4 != 0).sum())
        emit(phase="kernel_vs_plain", scene=scene_name, kernel="K4", mode=mode,
             rays=B, rows=table.shape[0], identical_to_k1=ok1,
             identical_to_plain=okp, shuffled_identical=oks,
             max_abs_err=max(err1, errp, errs), ms=ms[0], k1_ms=ms[1],
             plain_ms=ms[2], device_ms=dms, steps=int(s4.sum()),
             min_steps=int(s4.min()),
             flagged=flagged, hit_rate=float((h4.tri >= 0).float().mean()))
        if not (ok1 and okp and oks):
            fail(f"K4 disagrees with K1 or the plain version ({scene_name}, {mode})")
        if flagged:
            fail(f"capped or overflowed rays in {scene_name} {mode}")
        out[mode] = (max(err1, errp, errs), *ms, int(s4.sum()), dms)
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


def record_k1(run, traversal8, Rays):
    """Run `run()` with intersect_scene's kernel choice (traversal8._wide_fn)
    wrapped so that each K1 call's table, a copy of its rays and its mode
    are recorded (every call still launches K1 and counts); returns the list
    of (table, rays, kw)."""
    calls, orig = [], traversal8._wide_fn

    def wide_fn(table, pool=False):
        fn = orig(table, pool)

        def rec(table, rays, **kw):
            calls.append((table, Rays(*(x.clone() for x in rays)),
                          {k: v for k, v in kw.items()
                           if k in ("any_hit", "any_mask") and v is not None}))
            return fn(table, rays, **kw)
        return rec
    traversal8._wide_fn = wide_fn
    try:
        run()
    finally:
        traversal8._wide_fn = orig
    return calls


def k1_on_calls(label, calls, K1, traversal8, mb):
    """K1 against its plain version on each recorded call of one pass
    (check_variants: every field identical, the call timed, its device time
    and one plain run taken, its bound by trav_bound), summed by mode.
    Emits one more line per mode; returns {mode: dict}."""
    out = {}
    for i, (table, rays, kw) in enumerate(calls):
        mode = traversal8.launch_mode(kw.get("any_hit", False), kw.get("any_mask"))
        B = rays.o.shape[0]

        def run(variant, kw):
            h, st, fl = K1(table, rays, with_iters=True, **kw)
            return (*h, st, fl), st, fl

        def plain(kw):
            h, st, fl = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
            return (*h, st, fl), st, fl
        res = check_variants(
            "K1", run, plain, {mode: kw}, (None,), timed=(mode,), plain_reps=1,
            bound=lambda steps: trav_bound(table, B, steps, mode == "mixed",
                                           mb, traversal8),
            pass_of=label, call=i, rays=B)[mode, None]
        r = out.setdefault(mode, dict(launches=0, rays=0, live_rays=0, err=0.0,
                                      ms=0.0, device_ms=0.0, plain_ms=0.0,
                                      steps=0, bound_ms=0.0))
        r["launches"] += 1
        r["rays"] += B
        r["live_rays"] += int((rays.tmax > rays.tmin).sum())
        r["err"] = max(r["err"], res["err"])
        for k in ("ms", "device_ms", "plain_ms", "steps"):
            r[k] += res[k]
        r["bound_ms"] += res["bound"][0]
    for mode, r in out.items():
        emit(phase="kernel_on_pass", kernel="K1", pass_of=label, mode=mode,
             identical=True, max_abs_err=r["err"], **{k: v for k, v in r.items()
                                                      if k != "err"})
    return out


def timed_passes(tr, n):
    """n passes of `tr`, each timed to torch.cuda.synchronize (do_pass);
    returns (pass seconds, live rays per pass or None)."""
    secs, rays_n = [], []
    for _ in range(n):
        before = getattr(tr, "rays_traced_live", None)
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        if before is not None:
            rays_n.append(tr.rays_traced_live - before)
    return secs, rays_n or None


def card_vs_cpu(name, make, scene_fn, size, passes, dev, **extra):
    """The same tracer on the card and on the CPU, pass by pass: the mean
    relative error of the cumulative image after each pass, every image
    finite and not black; fails over CARD_CPU_LIMIT. Returns the readings."""
    trs = [make(scene_fn(size, size).build(d)) for d in (dev, "cpu")]
    rels = []
    for _ in range(passes):
        imgs = [tr.render(1).cpu().numpy() for tr in trs]
        for img in imgs:
            if not np.isfinite(img).all() or not img.mean() > 0.0:
                fail(f"the {name} card-vs-CPU image is not finite and non-black")
        rels.append(float(np.abs(imgs[0] - imgs[1]).mean()
                          / max(imgs[1].mean(), 1e-9)))
    emit(phase="card_vs_cpu", tracer=name, size=size, passes=passes,
         rel_err=max(rels), rel_err_by_pass=rels, limit=CARD_CPU_LIMIT, **extra)
    if not max(rels) < CARD_CPU_LIMIT:
        fail(f"the {name} card image differs from the CPU image: {rels}")
    return rels


def golden_rel(img, name):
    """tests/test_goldens_family.py's rule: the mean relative error against
    tests/goldens/<name>."""
    ref = np.load(os.path.join(HERE, "tests", "goldens", name))["img"]
    return float(np.abs(img - ref).mean() / max(ref.mean(), 1e-6))


def light_path_phases(dev, K1, K4, zero_counts, plain_calls, k1_by_variant,
                      primmod, bdptmod, ltmod, filmmod, example_scenes,
                      traversal8, mb):
    """4d. the PrimTracer headline (BASELINE config 1): Cornell 512^2,
    shading normals, one warm-up pass, then PRIM_PASSES timed passes, one K1
    launch (shared) per pass; one more pass profiled and one recorded, its
    K1 call held to the plain version and timed; the 64^2 card film within
    CARD_CPU_LIMIT of the CPU film. 4e. the BDPT headline (BASELINE config 4): the glass Cornell box
    256^2, depth 6, a warm-up pass, then LP_PASSES timed passes, its K1
    launches per pass by mode against the count worked out from the code
    (NUM_LIGHT_V closest-hit light-walk and any-hit splat traversals, then
    per camera bounce one closest-hit, one any-hit NEE and NUM_LIGHT_V
    any-hit connection traversals), one pass profiled; K1 against its plain
    version on every traversal of one more pass, recorded; then the light
    tracer likewise (1 + 2 * depth launches per pass). 4f. the card's
    images: BDPT (Cornell 32^2, depth 4, 6 passes) and the light tracer
    (depth 4, 12 passes) against their goldens (mean relative error < 0.02),
    and both on the glass Cornell box 32^2, depth 6, CARD_CPU_PASSES
    passes, against the same renders on the CPU (card_vs_cpu). Returns the
    K1 records of one PrimTracer, one BDPT and one light-tracer pass."""
    from cudatracerlib_tpu_torch.ops.traversal import Rays

    def counts():
        return dict(K1=K1.launches, K1_by_variant=dict(K1.launches_by_variant),
                    K1_by_mode=dict(K1.launches_by_mode), K4=K4.launches,
                    plain=plain_calls())

    def check_image(img, what):
        if not np.isfinite(img).all() or not img.mean() > 0.0:
            fail(f"the {what} image is not finite and non-black")

    def record(tr, label):
        calls = record_k1(tr.do_pass, traversal8, Rays)
        return dict(launches_per_pass=len(calls),
                    by_mode=k1_on_calls(label, calls, K1, traversal8, mb))

    out = {}
    # 4d. PrimTracer
    scene = example_scenes.cornell_box(512, 512).build(dev)
    tr = primmod.PrimTracer(scene, 512, 512, draw_mode=primmod.D_NORMAL_SHADE)
    tr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    it0, rw0 = int(tr._iters_dev), int(tr._rows_dev)
    secs, _ = timed_passes(tr, PRIM_PASSES)
    c = counts()
    k1_by_variant["prim"] = c["K1_by_variant"]
    img = filmmod.develop(tr.film).cpu().numpy()
    emit(phase="headline", scene="cornell_box", tracer="PrimTracer",
         draw_mode="D_NORMAL_SHADE", size=512, passes=PRIM_PASSES,
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         mrays_per_s=512 * 512 * PRIM_PASSES / sum(secs) / 1e6,
         steps=int(tr._iters_dev) - it0, rows=int(tr._rows_dev) - rw0,
         launches=c, launches_per_pass=c["K1"] / PRIM_PASSES,
         mean_value=float(img.mean()))
    check_image(img, "PrimTracer")
    if (c["K1"] != PRIM_PASSES or c["K1_by_variant"]["shared"] != c["K1"]
            or c["K4"] or c["plain"]):
        fail(f"the PrimTracer run took the wrong kernels: {c}")
    profile_pass(tr, "cornell_box", tracer="PrimTracer")
    out["prim"] = record(tr, "prim_cornell_512")
    card_vs_cpu("PrimTracer", lambda s: primmod.PrimTracer(
        s, 64, 64, draw_mode=primmod.D_NORMAL_SHADE), example_scenes.cornell_box,
        64, 1, dev)
    del tr, scene

    # 4e. BDPT and the light tracer on the glass Cornell box
    scene = example_scenes.cornell_glass(256, 256).build(dev)
    nv = bdptmod.NUM_LIGHT_V
    for name, make, want in (
            ("bdpt", lambda: bdptmod.BDPT(scene, 256, 256, max_depth=LP_DEPTH),
             dict(closest=nv + LP_DEPTH, any_hit=nv + LP_DEPTH * (1 + nv), mixed=0)),
            ("lt", lambda: ltmod.LightTracer(scene, 256, 256, max_depth=LP_DEPTH),
             dict(closest=LP_DEPTH, any_hit=1 + LP_DEPTH, mixed=0))):
        tr = make()
        tr.do_pass()
        torch.cuda.synchronize()
        zero_counts()
        secs, rays_n = timed_passes(tr, LP_PASSES)
        c = counts()
        k1_by_variant[name] = c["K1_by_variant"]
        img = filmmod.develop(tr.film).cpu().numpy()
        per_pass = {m: n / LP_PASSES for m, n in c["K1_by_mode"].items()}
        emit(phase="headline", scene="cornell_glass", tracer=type(tr).__name__,
             size=256, max_depth=LP_DEPTH, passes=LP_PASSES,
             seconds_per_pass=statistics.median(secs), pass_seconds=secs,
             mpaths_per_s=256 * 256 * LP_PASSES / sum(secs) / 1e6,
             spp_per_s=LP_PASSES / sum(secs), live_rays=int(sum(rays_n)),
             mrays_per_s=sum(rays_n) / sum(secs) / 1e6, launches=c,
             launches_per_pass_by_mode=per_pass, expected_per_pass_by_mode=want,
             mean_radiance=float(img.mean()))
        check_image(img, name)
        if (per_pass != {m: float(n) for m, n in want.items()}
                or c["K1_by_variant"]["shared"] != c["K1"] or c["K4"] or c["plain"]):
            fail(f"the {name} run took the wrong kernels: {c}, expected {want} per pass")
        profile_pass(tr, "cornell_glass", tracer=type(tr).__name__)
        out[name] = record(tr, f"{name}_cornell_glass_256")
        del tr
    del scene

    # 4f. the card's images against the goldens and the CPU
    for name, make, passes, golden in (
            ("bdpt", lambda s: bdptmod.BDPT(s, 32, 32, max_depth=4), 6,
             "cornell_32_bdpt.npz"),
            ("lt", lambda s: ltmod.LightTracer(s, 32, 32, max_depth=4), 12,
             "cornell_32_lt.npz")):
        img = make(example_scenes.cornell_box(32, 32).build(dev)).render(passes)
        img = img.cpu().numpy()
        rel = golden_rel(img, golden)
        emit(phase="golden", tracer=name, size=32, max_depth=4, passes=passes,
             rel_err=rel, limit=0.02)
        check_image(img, f"{name} golden")
        if not rel < 0.02:
            fail(f"{name} golden drift {rel}")
    for name, cls in (("BDPT", bdptmod.BDPT), ("LightTracer", ltmod.LightTracer)):
        card_vs_cpu(name, lambda s: cls(s, 32, 32, max_depth=LP_DEPTH),
                    example_scenes.cornell_glass, 32, CARD_CPU_PASSES, dev,
                    scene="cornell_glass", max_depth=LP_DEPTH)
    return out


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "cudatracerlib_tpu_torch")):
        fail("run from a checkout of the repository")
    from cudatracerlib_tpu_torch.models import bdpt as bdptmod
    from cudatracerlib_tpu_torch.models import film as filmmod
    from cudatracerlib_tpu_torch.models import lighttracer as ltmod
    from cudatracerlib_tpu_torch.models import path as pathmod
    from cudatracerlib_tpu_torch.models import prim as primmod
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
        K1.launches_by_mode = dict.fromkeys(K1.launches_by_mode, 0)
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
    # the global ones with LDG; K3's staging probe designs stage with
    # LDGSTS and read a staged row on chip (LDS from the block's own shared
    # memory, or a generic LD: through the cluster's shared windows, or
    # where the split design's row may lie in either memory), so each must
    # hold at least as many such 128-bit loads as K3 holds LDGs (one step's
    # row loads): a staged row read with LDG fails
    shared_bytes = dict(shared="rows * 512",
                        staged="the staged rows * 512 / blocks")
    k3_loads = None
    for src in ("traversal8.cu", "traversal_tt.cu", "traversal_pool.cu",
                "schedule_probe.cu"):
        loads = sass_loads(cuda_build.build_log[src]["path"],
                           cuda_build.find_nvcc())
        if src == "schedule_probe.cu":
            # K3's staging designs only (the walk stages nothing; the rest
            # are K1's and K2's designs or copies of the kernels above)
            loads = {fn: ops for fn, ops in loads.items()
                     if fn.startswith("probe_treelet_kernel<")
                     and "walk" not in fn}
        else:
            k3_loads = k3_loads or loads.get("treelet_hits_kernel")
        step_loads = sum(n for op, n in (k3_loads or {}).items()
                         if op.startswith("LDG."))
        for fn, ops in loads.items():
            kind = ("shared" if "_shared_" in fn else
                    "staged" if fn.startswith("probe_treelet") else "global")
            lds = sum(n for op, n in ops.items() if op.startswith("LDS"))
            ldg = sum(n for op, n in ops.items() if op.startswith("LDG."))
            generic = sum(n for op, n in ops.items() if op.startswith("LD."))
            emit(phase="sass", kernel=fn, kind=kind, loads_128=ops,
                 on_chip_row_loads=lds + generic if kind == "staged" else None,
                 dynamic_shared_bytes=shared_bytes.get(kind, 0))
            bad = {"shared": lds == 0 or generic > 0, "global": ldg == 0,
                   "staged": (lds + generic < step_loads or step_loads == 0
                              or "LDGSTS.E.BYPASS.128" not in ops)}[kind]
            if bad:
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
    secs, rays_n = timed_passes(tr, 4)
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
    zero_counts()
    t0 = time.perf_counter()
    ta = pathmod.PathTracer(anchor, aw, ah, max_depth=adepth, rr_depth=4,
                            use_nee=True, spp_per_pass=16)
    ta.render_batched(spp // 16)
    anchor_run = dict(seconds=time.perf_counter() - t0, k1=K1.launches,
                      k4=K4.launches, plain=plain_calls(),
                      ovf=[int(x) for x in ta._ovf_dev.tolist()])
    got = filmmod.develop(ta.film).cpu().numpy().astype(np.float64)
    rmse = float(np.sqrt(((got - 0.5 * (ref_a + ref_b)) ** 2).mean()))
    mean_got, mean_ref = float(got.mean()), float(ref_a.mean())
    mean_bound = 0.05 * max(mean_ref, 1e-6) + 3.0 * noise
    mean_gap = abs(mean_got - mean_ref) / max(mean_ref, 1e-6)
    emit(phase="veach_anchor", size=aw, spp=spp, passes=spp // 16,
         spp_per_pass=16, max_depth=adepth, rmse=rmse, noise_floor=noise,
         limit=CAL * noise, mean=mean_got, mean_ref=mean_ref,
         mean_bound=mean_bound, mean_gap=mean_gap, mean_gap_limit=MEAN_GAP,
         run=anchor_run)
    if not (rmse < CAL * noise and abs(mean_got - mean_ref) < mean_bound
            and mean_gap < MEAN_GAP):
        fail(f"veach anchor: RMSE {rmse} vs {CAL} x {noise}, mean {mean_got} vs {mean_ref}")
    if anchor_run["k1"] <= 0 or anchor_run["k4"] or anchor_run["plain"]:
        fail(f"the anchor run took the wrong kernels: {anchor_run}")
    del anchor, ta

    # 4c. the veach-mis headline, after a warm-up pass
    vtr = pathmod.PathTracer(veach, 512, 512, max_depth=5, chunk_size=65536)
    vtr.do_pass()
    torch.cuda.synchronize()
    zero_counts()
    secs, rays_n = timed_passes(vtr, 8)
    counts = dict(K1=K1.launches, K4=K4.launches, K2=K2.launches,
                  K3=K3.launches, plain=plain_calls(),
                  K1_by_variant=dict(K1.launches_by_variant))
    k1_by_variant["veach_mis"] = dict(K1.launches_by_variant)
    img = filmmod.develop(vtr.film).cpu().numpy()
    capped, overflowed = (int(x) for x in vtr._ovf_dev.tolist())
    emit(phase="headline", scene="veach_mis", tris=veach.num_tris, size=512,
         max_depth=5, chunk_size=65536, passes=8, kernel="K1",
         seconds_per_pass=statistics.median(secs), pass_seconds=secs,
         live_rays=int(sum(rays_n)), mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         launches=counts, steps=int(vtr._iters_dev), capped=capped,
         overflowed=overflowed, mean_radiance=float(img.mean()))
    if (counts["K1"] <= 0 or counts["K4"] or counts["K2"] or counts["K3"]
            or counts["plain"]):
        fail(f"the veach-mis run took the wrong kernels: {counts}")
    if K1.launches_by_variant["shared"] != K1.launches:
        fail(f"veach-mis K1 launches not all shared: {K1.launches_by_variant}")
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("the veach-mis image is not finite and non-black")
    if capped or overflowed:
        fail(f"veach-mis: capped {capped} / overflowed {overflowed} rays")
    if profile:
        profile_pass(vtr, "veach_mis", kernel="K1")
    del vtr, veach

    # 4d-4f. the light-path slice: PrimTracer, BDPT and LightTracer
    light_path = light_path_phases(
        dev, K1, K4, zero_counts, plain_calls, k1_by_variant, primmod, bdptmod,
        ltmod, filmmod, example_scenes, traversal8, mb)

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
    n_tt = slabs.shape[0]
    probe_split = (probe.CHUNK, probe.MIN_STAGE)

    def k3_designs(V, slots):
        """K3 and its probe designs (K3_DESIGNS) against its plain version
        on each mode's sorted slots {mode: (keys, order, t_prune)}; then, on
        the mixed slots, the probe's cluster and walk designs at each chunk
        size and staging threshold of K3_CHUNKS x K3_MIN_STAGES (identical,
        staged count against the plain model, device time), the cluster and
        split designs staging only, and the probe's split of the slots.
        Returns check_variants's result."""
        def run(design, m):
            keys, order, t_prune = m["slots"]
            if design is None:
                r = K3(slabs, sm_rays, t_prune, keys, order, V, **m["kw"])
            else:
                r = probe.treelet_hits(slabs, sm_rays, t_prune, keys, order, V,
                                       design, **m["kw"])
            return (*r[0], *r[1:]), r[1], r[2]

        def plain(m):
            keys, order, t_prune = m["slots"]
            r = traversal_tt.treelet_hits(slabs, sm_rays, t_prune, keys, order,
                                          V, **m["kw"])
            return (*r[0], *r[1:]), r[1], r[2]
        modes = {mode: dict(kw=kw, slots=slots[mode])
                 for mode, kw in sm_modes.items()}
        keys, order, t_prune = slots["mixed"]
        tid = keys >> traversal_tt.VID_ROOT_BITS
        valid = tid < n_tt
        needed = int(torch.unique(tid[valid]).numel())
        # K3 reads each slab that a valid visit names once, the rays (o, d,
        # tmin, the prune t, the any-hit mask) and the B*V keys and slots,
        # and writes one hit per slot (t, tri, u, v, steps, flags)
        res = check_variants(
            "K3", run, plain, modes, K3_DESIGNS,
            bound=lambda steps: mb.bound_ms(
                needed * slabs[0].numel() * 4 + B * 33 + B * V * 29,
                steps * traversal8.NODE_STEP_FLOPS),
            scene="san_miguel_stand_in", V=V, slots=B * V, treelets=n_tt,
            slab_rows=slabs.shape[1], treelets_visited=needed,
            cluster_blocks=probe.slab_variant(
                slabs.shape[1], torch.cuda.get_device_properties(dev)
                .shared_memory_per_block_optin))
        kw = sm_modes["mixed"]
        ref = plain(modes["mixed"])[0]

        def probe_run(chunk, min_stage, design="cluster", stage_only=False,
                      scratch=None):
            return probe.treelet_hits(slabs, sm_rays, t_prune, keys, order, V,
                                      design, chunk, min_stage, stage_only,
                                      _scratch=scratch, **kw)
        for chunk in K3_CHUNKS:
            for min_stage in K3_MIN_STAGES:
                staged = int(probe.treelet_segments(
                    keys, n_tt, chunk, min_stage)[3].sum())
                for design in ("cluster", "walk"):
                    scratch = torch.empty(2, dtype=torch.int32, device=dev)
                    got = probe_run(chunk, min_stage, design, scratch=scratch)
                    ok, err = same((*got[0], *got[1:]), ref)
                    dms = device_ms(lambda: probe_run(chunk, min_stage, design))
                    emit(phase="k3_sweep", V=V, design=design, chunk=chunk,
                         min_stage=min_stage, device_ms=dms, identical=ok,
                         max_abs_err=err, staged=int(scratch[1]),
                         staged_model=staged)
                    if not ok or int(scratch[1]) != staged:
                        fail(f"K3's {design} design at chunk {chunk}, "
                             f"min_stage {min_stage}: identical {ok}, staged "
                             f"{int(scratch[1])} against the model's {staged}")
        stage_only = {d: device_ms(lambda: probe_run(*probe_split, design=d,
                                                     stage_only=True))
                      for d in ("cluster", "split")}
        scratch = torch.empty(2, dtype=torch.int32, device=dev)
        probe_run(*probe_split, scratch=scratch)
        start, end, _, staged = probe.treelet_segments(keys, n_tt, *probe_split)
        n_staged, n_valid = int(staged.sum()), int(valid.sum())
        staged_visits = int((end - start)[staged].sum())
        split = dict(chunk=probe_split[0], min_stage=probe_split[1],
                     slots=B * V, valid_visits=n_valid,
                     segments=int(start.numel()), staged=int(scratch[1]),
                     staged_model=n_staged,
                     visits_per_staged_segment=staged_visits / max(n_staged, 1),
                     unstaged_share=1 - staged_visits / max(n_valid, 1),
                     stage_only_device_ms=stage_only)
        emit(phase="k3_split", V=V, **split)
        if int(scratch[1]) != n_staged:
            fail(f"K3 staged {int(scratch[1])} segments, the model {n_staged}")
        k3_splits[V] = split
        return res

    k2_res, k3_res, k3_splits, k4_fallback = {}, {}, {}, {}
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
        k2_out = {mode: K2(top, sm_rays, V, **kw) for mode, kw in sm_modes.items()}
        k3_res[V] = k3_designs(V, {mode: traversal_tt.visit_slots(
            k2[0], k2[1], k2[3], n_tt, traversal8.any_lanes(
                B, kw.get("any_hit", False), kw.get("any_mask"), dev))[1:]
            for (mode, kw), k2 in zip(sm_modes.items(), k2_out.values())})
        for mode, kw in sm_modes.items():
            h1 = k1_res[mode]
            any_lane = traversal8.any_lanes(B, kw.get("any_hit", False),
                                            kw.get("any_mask"), dev)
            vcnt = k2_out[mode][3]
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
                # K1 on the exact path's fallback batch: every lane whose
                # visits did not overflow has tmax -1 and takes one step
                fb = Rays(sm_rays.o, sm_rays.d, sm_rays.tmin,
                          torch.where(tk[1], tk[0].t, -1.0))
                kernel_ms["K1_fallback", V] = k1_variants(
                    f"san_miguel_fallback_V{V}", wide, fb, sm_mask, (None,),
                    only_mixed=True)["mixed", None]
                # K4 on the same batch: its per-lane refill against K1's
                # one thread per ray, identical on every field
                k4_fallback[V] = check_pool(f"san_miguel_fallback_V{V}", wide, fb,
                                            sm_mask, K1, K4, traversal8, Rays, 7 + V)
            emit(phase="sm_kernels_vs_plain", mode=mode, rays=B, V=V,
                 two_phase_identical=okt, max_abs_err=errt,
                 visits=int(vcnt.sum()), visits_kept=int(vcnt.clamp_max(V).sum()),
                 dropped_visits=int((vcnt - V).clamp_min(0).sum()),
                 count_dropped_visits=[total, dropped],
                 fallback_rays=int(tk[1].sum()), treelet_steps=int(ex_iters),
                 flags=[int(x) for x in ex_flags.tolist()],
                 exact_t_identical=t_same, tri_ties=ties,
                 any_hit_lanes_identical=hit_same, **times)
            if not okt:
                fail(f"the two-phase path disagrees with its plain version "
                     f"({mode}, V={V})")
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
    secs, rays_n = timed_passes(tr, 2)
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

    def k3_row(name, src, design):
        """One row per K3 design at V=3, both budgets under by_v: the kept
        kernel (design None) with its launches on the main path, the
        probe's designs with none; the probe's split of the slots beside
        the cluster design."""
        n = {V: launches["K3", V] if design is None else 0 for V in k3_res}
        by_v = {f"V{V}": dict(launches=n[V], **brief(k3_res[V]["mixed", design]))
                for V in k3_res}
        return vrow(name, src, "cudatracerlib_tpu/ops/traversal_tt.py:340",
                    sum(n.values()), max(max_err(k3_res[V], design) for V in k3_res),
                    k3_res[traversal8.V_INCOHERENT]["mixed", design],
                    design=design or "kept", by_v=by_v,
                    split={f"V{V}": k3_splits[V] for V in k3_splits}
                    if design == "cluster" else None)

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
                                       ("veach_mis", k1_veach))},
             by_tracer={name: dict(launches=k1_by_variant[name]["shared"],
                                   one_pass=rec)
                        for name, rec in light_path.items()}),
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
        k3_row("treelet_hits_kernel", "traversal_tt.cu", None),
        *(k3_row(f"probe_treelet_kernel<{d}>", "schedule_probe.cu", d)
          for d in probe.K3_DESIGNS),
        row("traverse_pool_kernel", "traversal_pool.cu",
            "cudatracerlib_tpu/ops/traversal_pl.py:298", 0,
            max(k4_res["mixed"][0], *(r["mixed"][0] for r in k4_fallback.values())),
            k4_res["mixed"][1], k4_res["mixed"][3], k4_bound,
            device_ms=k4_res["mixed"][5], on_path=False,
            fallback_by_v={f"V{V}": dict(
                ms=r["mixed"][1], k1_ms=r["mixed"][2], plain_ms=r["mixed"][3],
                device_ms=r["mixed"][5],
                k1_device_ms=kernel_ms["K1_fallback", V]["device_ms"])
                for V, r in k4_fallback.items()}),
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
