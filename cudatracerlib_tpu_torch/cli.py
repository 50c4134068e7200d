"""Command-line renderer.

Port of ``cudatracerlib_tpu/cli.py`` (the reference's ``main.cpp:135-180``:
``CudaTracerLib <data> <scene.xml> <passes> {direct,PT,PT_Wave,BDPT,PPPM}``
with a progress bar and a PNG at the end). Renders on the card unless
``--device cpu`` asks for the CPU:

    python -m cudatracerlib_tpu_torch scene.xml -o out.png -t PT -p 64
    python -m cudatracerlib_tpu_torch cornell -t BDPT -p 8 --devices 2

``--devices N`` starts N ranks (parallel.render.launch: one spawned process
per card, NCCL; gloo with ``--device cpu``) that render with the sharded
tracers; rank 0 writes the outputs: the gathered film without the splat
parts, as the JAX CLI writes ``tr.film``, so a sharded light tracer's image
is black and a sharded BDPT's or VCM's lacks its splats (ROADMAP queue 3,
item 7). Without it one process renders on one device.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def _coerce(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for t in (int, float):
        try:
            return t(v)
        except ValueError:
            pass
    return v


def build_tracer(name: str, scene_data, settings, args, devices: int = None):
    """args: list of "name=value" strings forwarded to the tracer's
    constructor (the reference's TracerArguments string->parameter path,
    TracerSettings.h:352-383), e.g. --arg vol_estimator=beambeam
    --arg adaptive_radii=true --arg sampler_type=2.

    devices (an int, even 1) renders with the sharded tracers over the
    running world's mesh (``parallel.render.make_mesh(devices)``): PT and
    the wavefront names, BDPT, PPM, VCM and LT. None renders on one device."""
    from .models import (adaptive, bdpt, fast, game, lighttracer, path, ppm,
                         prim, vcm)
    w, h = settings.width, settings.height
    name = name.lower()
    kw = {}
    for s in args or []:
        k, _, v = s.partition("=")
        kw[k.strip()] = _coerce(v.strip())
    if devices is not None:
        from .parallel import render as prender
        mesh = prender.make_mesh(devices, device=scene_data.device)
        sharded = {"pt": prender.ShardedPathTracer,
                   "path": prender.ShardedPathTracer,
                   "pt_wave": prender.ShardedPathTracer,
                   "wavefront": prender.ShardedPathTracer,
                   "bdpt": prender.ShardedBDPT,
                   "ppm": prender.ShardedPPMTracer,
                   "pppm": prender.ShardedPPMTracer,
                   "vcm": prender.ShardedVCM,
                   "lt": prender.ShardedLightTracer,
                   "lighttracer": prender.ShardedLightTracer,
                   "photontracer": prender.ShardedLightTracer}
        if name not in sharded:
            raise SystemExit(f"--devices: tracer '{name}' has no sharded "
                             "variant (PT/BDPT/PPM/VCM/LT do)")
        cls = sharded[name]
        if name not in ("lt", "lighttracer", "photontracer"):
            kw.setdefault("max_depth", min(settings.max_depth, 8))
        return cls(scene_data, w, h, mesh=mesh, **kw)
    if name in ("direct", "prim"):
        return prim.PrimTracer(scene_data, w, h,
                               **{"draw_mode": prim.D_ALBEDO, **kw})
    if name in ("pt", "path"):
        return path.PathTracer(scene_data, w, h, max_depth=settings.max_depth,
                               rr_depth=settings.rr_depth, **kw)
    if name in ("pt_wave", "wavefront"):
        return path.PathTracer(scene_data, w, h, max_depth=settings.max_depth,
                               **{"chunk_size": 1 << 16, **kw})
    if name in ("pt_adaptive", "adaptive"):
        return adaptive.AdaptivePathTracer(scene_data, w, h,
                                           max_depth=settings.max_depth, **kw)
    if name == "bdpt":
        return bdpt.BDPT(scene_data, w, h,
                         max_depth=min(settings.max_depth, 8), **kw)
    if name in ("ppm", "pppm"):
        return ppm.PPMTracer(scene_data, w, h,
                             max_depth=min(settings.max_depth, 8), **kw)
    if name == "vcm":
        return vcm.VCM(scene_data, w, h,
                       max_depth=min(settings.max_depth, 8), **kw)
    if name in ("lt", "lighttracer", "photontracer"):
        return lighttracer.LightTracer(scene_data, w, h,
                                       max_depth=settings.max_depth, **kw)
    if name == "fast":
        return fast.FastTracer(scene_data, w, h, **kw)
    if name == "game":
        return game.GameTracer(scene_data, w, h, **kw)
    raise SystemExit(f"unknown tracer '{name}'")


def _parser():
    ap = argparse.ArgumentParser(
        prog="cudatracerlib_tpu_torch",
        description="Physically based renderer on an NVIDIA card (Mitsuba-XML scenes)")
    ap.add_argument("scene", help="Mitsuba XML scene file, or 'cornell' for the builtin box")
    ap.add_argument("-o", "--output", default="result.png")
    ap.add_argument("-t", "--tracer", default=None,
                    help="direct|PT|PT_Wave|adaptive|BDPT|PPM|VCM|LT|fast|game")
    ap.add_argument("-p", "--passes", type=int, default=None)
    ap.add_argument("--res", default=None, help="WxH override")
    ap.add_argument("--tonemap", action="store_true")
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--filter", default="box",
                    choices=["box", "gaussian", "mitchell", "lanczos", "triangle"])
    ap.add_argument("--hdr", default=None, help="also write a Radiance .hdr")
    ap.add_argument("--arg", action="append", default=[],
                    help="name=value tracer parameter (repeatable)")
    ap.add_argument("--debug-pixel", default=None, help="x,y: print one-pixel debug info")
    ap.add_argument("--devices", type=int, default=None,
                    help="render over N ranks, one card each (PT/BDPT/PPM/VCM/LT)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--debug-nans", action="store_true",
                    help="fail on the first pass whose film holds a non-finite "
                         "value (the counterpart of the reference's CTL_ASSERT "
                         "device checks)")
    return ap


def main(argv=None):
    a = _parser().parse_args(argv)
    if a.devices is None:
        return _render(None, a)
    from .parallel import render as prender
    prender.launch(_render, a.devices, args=(a,), device=a.device)


def _check_finite(film, pass_i):
    for k in ("rgb", "weight", "splat"):
        if not bool(torch.isfinite(getattr(film, k)).all()):
            raise FloatingPointError(f"non-finite value in film.{k} after pass {pass_i}")


def _render(mesh, a):
    """One rank's render (mesh None: one device). Every rank renders its
    shard; rank 0 prints and writes the outputs."""
    from .models import film as filmmod
    from .models import pipeline
    from .scene.loader import mitsuba
    from .utils import example_scenes

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a_, **k_: None)
    device = a.device if mesh is None else mesh.device
    res = tuple(int(v) for v in a.res.split("x")) if a.res else None
    t0 = time.perf_counter()
    if a.scene == "cornell":
        w, h = res or (512, 512)
        sc = example_scenes.cornell_box(w, h)
        settings = mitsuba.RenderSettings(width=w, height=h)
    else:
        sc, settings = mitsuba.load_mitsuba(a.scene, override_res=res)
    scene_data = sc.build(device)
    say(f"[scene] {scene_data.num_tris} tris, {scene_data.num_lights} lights, "
        f"{settings.width}x{settings.height} ({time.perf_counter() - t0:.1f}s)")

    tracer_name = a.tracer or settings.integrator
    tr = build_tracer(tracer_name, scene_data, settings, a.arg,
                      devices=None if mesh is None else mesh.size)
    n_passes = a.passes if a.passes is not None else max(settings.spp, 1)
    if not tr.progressive:
        n_passes = 1

    if a.debug_pixel:
        x, y = (int(v) for v in a.debug_pixel.split(","))
        say(tr.debug_pixel(x, y))

    for i in range(n_passes):
        tr.do_pass()
        if a.debug_nans:
            _check_finite(tr.film, i)
        done = (i + 1) * 20 // n_passes
        if lead:
            sys.stdout.write("\r[" + "=" * done + " " * (20 - done) +
                             f"] pass {i + 1}/{n_passes}  {tr.last_pass_seconds:.3f}s/pass")
            sys.stdout.flush()
    say()

    ftypes = {"box": pipeline.F_BOX, "gaussian": pipeline.F_GAUSSIAN,
              "mitchell": pipeline.F_MITCHELL, "lanczos": pipeline.F_LANCZOS,
              "triangle": pipeline.F_TRIANGLE}
    # the JAX CLI writes tr.film: with --devices, the gathered film without
    # the splat parts (ROADMAP queue 3, item 7)
    film = tr.film if mesh is None else tr.gathered_film(parts=False)
    if not lead:
        return
    hdr = pipeline.apply_pipeline(film, ftypes[a.filter], tonemap=a.tonemap,
                                  denoise=a.denoise, vb=getattr(tr, "vb", None))
    filmmod.save_png(hdr, a.output)
    if a.hdr:
        from .scene.loader import images
        images.write_hdr(a.hdr, hdr.cpu().numpy())
    st = tr.status()
    say(f"[done] {a.output}  {st.get('spp', n_passes)} spp in "
        f"{st['seconds']:.3f}s ({st.get('spp_per_second', 0):.2f} spp/s)")


if __name__ == "__main__":
    main()
