"""Drive the PyTorch/CUDA port on one NVIDIA card: build its kernel, check it
against its plain PyTorch version, and run the Cornell path-tracing pass.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and the repository
checkout; imports nothing of JAX. Each phase prints one JSON line, any
failure exits non-zero, and nothing falls back to the CPU:

1. the card's name and power limit; build the BVH8 traversal kernel
   (csrc/traversal8.cu) from source and time the build;
2. kernel against plain version on the Cornell 512^2 table with 131,072+513
   rays inside the box: closest-hit, any-hit and mixed any_mask (half the
   lanes any-hit). t, tri, u, v, step counts and flags must be identical
   (the kernel is built with -fmad=false, so both round op for op);
   median of 5 synchronised runs each;
3. PathTracer on Cornell 32^2, depth 4, 16 passes against
   tests/goldens/cornell_32_pt.npz (mean relative error < 0.02);
4. the headline slice: PathTracer on Cornell 512^2, max_depth 6, chunks of
   65,536 lanes, 4 passes. The launch counts are zeroed just before and
   read just after; every pass must go through the kernel, no CUDA tensor
   may reach the plain traversal, and no ray may be capped or overflow.

The line before the last is the kernel table, the last the device record.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "goldens", "cornell_32_pt.npz")
N_RAYS = 131072 + 513


def emit(**kw):
    print(json.dumps(kw), flush=True)


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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "cudatracerlib_tpu_torch")):
        fail("run from a checkout of the repository")
    from cudatracerlib_tpu_torch.models import film as filmmod
    from cudatracerlib_tpu_torch.models import path as pathmod
    from cudatracerlib_tpu_torch.ops import cuda_build, traversal8
    from cudatracerlib_tpu_torch.ops.traversal import Rays
    from cudatracerlib_tpu_torch.utils import example_scenes

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    emit(phase="card", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    # 1. build K1 from the checkout's source
    t0 = time.perf_counter()
    traversal8._load_kernel()
    log = cuda_build.build_log["traversal8.cu"]
    ptxas = [ln.strip() for ln in log["ptxas"].splitlines()
             if "registers" in ln or "stack frame" in ln]
    emit(phase="build", kernel="traversal8.cu",
         seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)

    # 2. kernel against its plain version at the main path's ray count
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
    modes = {"closest": {}, "any_hit": dict(any_hit=True),
             "mixed": dict(any_mask=amask)}
    compare = {}
    for mode, kw in modes.items():
        hk, sk, fk = traversal8.intersect_wide_cuda(table, rays, with_iters=True, **kw)
        hp, sp, fp = traversal8.intersect_wide(table, rays, with_iters=True, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(
            (hk.t, hk.tri, hk.u, hk.v, sk, fk), (hp.t, hp.tri, hp.u, hp.v, sp, fp)))
        err = max(float((a - b).abs().max()) for a, b in
                  zip((hk.t, hk.u, hk.v), (hp.t, hp.u, hp.v)))
        ms = cuda_median_ms(lambda: traversal8.intersect_wide_cuda(table, rays, **kw))
        plain_ms = cuda_median_ms(lambda: traversal8.intersect_wide(table, rays, **kw))
        compare[mode] = dict(identical=same, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             hit_rate=float((hk.tri >= 0).float().mean()),
                             steps=int(sk.sum()), flagged=int((fk != 0).sum()))
        emit(phase="kernel_vs_plain", mode=mode, rays=N_RAYS, rows=table.shape[0],
             **compare[mode])
        if not same:
            fail(f"kernel and plain version disagree ({mode})")
        if compare[mode]["flagged"]:
            fail(f"capped or overflowed rays in {mode}")

    # 3. golden image on the card
    traversal8.intersect_wide_cuda.launches = 0
    traversal8.intersect_wide.cuda_calls = 0
    tr32 = pathmod.PathTracer(example_scenes.cornell_box(32, 32).build(dev),
                              32, 32, max_depth=4, spp_per_pass=1)
    img = tr32.render(16).cpu().numpy()
    ref = np.load(GOLDEN)["img"]
    rel = float(np.abs(img - ref).mean() / max(ref.mean(), 1e-6))
    launches32 = traversal8.intersect_wide_cuda.launches
    emit(phase="golden", size=32, passes=16, rel_err=rel, limit=0.02,
         launches=launches32, plain_cuda_calls=traversal8.intersect_wide.cuda_calls)
    if not rel < 0.02:
        fail(f"golden drift {rel}")
    if launches32 <= 0 or traversal8.intersect_wide.cuda_calls:
        fail("the golden pass did not run through the kernel alone")

    # 4. the headline slice: the main path, with the counts zeroed around it
    tr = pathmod.PathTracer(scene512, 512, 512, max_depth=6, chunk_size=65536)
    torch.cuda.synchronize()
    traversal8.intersect_wide_cuda.launches = 0
    traversal8.intersect_wide.cuda_calls = 0
    secs, rays_n = [], []
    for _ in range(4):
        before = tr.rays_traced_live
        tr.do_pass()
        secs.append(tr.last_pass_seconds)
        rays_n.append(tr.rays_traced_live - before)
    img = filmmod.develop(tr.film).cpu().numpy()
    launches = traversal8.intersect_wide_cuda.launches
    plain_calls = traversal8.intersect_wide.cuda_calls
    capped, overflowed = (int(x) for x in tr._ovf_dev.tolist())
    emit(phase="headline", scene="cornell_box", size=512, max_depth=6,
         chunk_size=65536, passes=4, seconds_per_pass=statistics.median(secs),
         pass_seconds=secs, live_rays=int(sum(rays_n)),
         mrays_per_s=sum(rays_n) / sum(secs) / 1e6,
         steps=int(tr._iters_dev), capped=capped, overflowed=overflowed,
         launches=launches, plain_cuda_calls=plain_calls,
         mean_radiance=float(img.mean()), finite=bool(np.isfinite(img).all()))
    if not np.isfinite(img).all() or not img.mean() > 0.0:
        fail("headline image is not finite and non-black")
    if capped or overflowed:
        fail(f"capped {capped} / overflowed {overflowed} rays")
    if launches <= 0 or plain_calls:
        fail("the headline pass did not run through the kernel alone")

    emit(kernels=[dict(
        name="traverse8_kernel", route="cuda",
        source="cudatracerlib_tpu_torch/csrc/traversal8.cu",
        replaces="cudatracerlib_tpu/ops/traversal_pl.py:188",
        launches=launches, max_abs_err=compare["mixed"]["max_abs_err"],
        ms=compare["mixed"]["ms"], plain_ms=compare["mixed"]["plain_ms"])])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
