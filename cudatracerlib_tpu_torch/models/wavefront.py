"""Regenerating wavefront path tracer: a fixed lane pool at full occupancy.

Port of ``cudatracerlib_tpu/models/wavefront.py`` (the reference's
``Integrators/WavefrontPathTracer.cu``): terminated paths are replaced by
fresh camera paths pulled from a path queue, so every traversal runs over
a full pool of live lanes instead of the chunked tracer's shrinking batch.
Each iteration (1) traces ONE merged wavefront, every live lane's
closest-hit ray plus every pending NEE shadow ray (per-lane any-hit), (2)
resolves the previous vertex's NEE, (3) adds finished paths to the film
and (4) regenerates those lanes from the queue, ranked by a prefix sum.
The per-pixel sample set is the chunked ``path.PathTracer``'s (the RNG is
seeded by pixel, sample and pass): the same image up to the film's
summation order, and the same live rays.

The JAX package's ``lax.while_loop`` is a Python loop here whose condition
is one read back from the device per iteration (queue left, any lane
active or draining); ``host_reads`` counts them. The bounce shares its
math with ``path.pt_radiance`` (MIS at emitters, NEE, Russian roulette,
alpha masks, bump and parallax mapping, path regularization). Media-free
scenes only, as in the JAX package. A lane refilled from the path queue
starts with had_smooth (a smooth bounce taken, for regularization) false.
As the JAX package's WavefrontPT, and unlike PathTracer, it does not widen
its default active types (the scene's) by the rough types regularization
turns delta lobes into: in a scene without a rough dielectric or rough
conductor a regularized delta lane then samples no active type, its weight
is 0 and its path ends. A caller who wants the widened set passes
``active_types=path.regularized_types(...)``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import records
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema
from . import bsdf as bsdfmod
from . import film as filmmod
from . import medium as mediummod
from . import path as pathmod
from . import tracer

Tensor = torch.Tensor

host_reads = 0   # the loop's exit tests read back from the device, all passes


def _wf_pass(scene: schema.SceneData, film: filmmod.Film, rays_ctr,
             iters_ctr, rows_ctr, ovf_ctr, pass_idx,
             w: int, h: int, lanes: int, spp: int, max_depth: int,
             rr_depth: int, use_nee: bool, active_types,
             with_alpha: bool = False, with_bump: bool = False,
             with_parallax: bool = False, regularize: bool = False,
             regularize_alpha: float = 0.08, with_textures: bool = True):
    """One full progressive pass (spp * w * h camera paths) through a
    regenerating pool of `lanes` slots. Returns (film, rays, iters, rows,
    ovf) counters advanced by the pass, and the pass's loop iterations and
    host reads."""
    global host_reads
    B = lanes
    n_paths = w * h * spp
    geom = scene.geom
    dev = film.rgb.device
    f32 = dict(dtype=torch.float32, device=dev)
    params = scene.sensor.params
    cone = 2.0 * torch.tan(0.5 * params[0]) / params[5].clamp_min(1.0)

    def gen(qidx):
        """Camera paths for queue indices q: pixel q % (w*h), sample q//(w*h)."""
        return tracer.gen_camera_rays(scene, qidx % (w * h),
                                      pass_idx * spp + qidx // (w * h),
                                      pass_idx, w, h)

    # initial fill: lanes 0..B-1 take queue slots 0..B-1
    q0 = torch.arange(B, dtype=torch.int32, device=dev)
    cur, px, py, state, wt = gen(q0.clamp_max(n_paths - 1))
    active = q0 < n_paths
    cur = cur._replace(tmax=torch.where(active, cur.tmax, 0.0))
    qhead = torch.tensor(min(B, n_paths), dtype=torch.int32, device=dev)
    L = torch.zeros((B, 3), **f32)
    beta = torch.ones((B, 3), **f32)
    fin = torch.zeros(B, dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros(B, **f32)
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)
    had_smooth = torch.zeros(B, dtype=torch.bool, device=dev)
    p_contrib = torch.zeros((B, 3), **f32)
    p_rays = pathmod._dead_rays(B, dev)
    p_act = torch.zeros(B, dtype=torch.bool, device=dev)
    depth = torch.zeros(B, dtype=torch.int32, device=dev)
    amask = torch.cat([torch.zeros(B, dtype=torch.bool, device=dev),
                       torch.ones(B, dtype=torch.bool, device=dev)])
    zero = torch.zeros(B, **f32)
    # safety bound: every lane runs <= ceil(paths/B) paths of <= max_depth+1
    # iterations each, plus the initial fill and the drain
    limit = (n_paths // B + 2) * (max_depth + 2)
    it = reads = 0

    while it < limit:
        more = (qhead < n_paths) | active.any() | fin.any()
        host_reads += 1
        reads += 1
        if not bool(more):
            break
        trace_rays = cur._replace(tmax=torch.where(active, cur.tmax, 0.0))
        rays_ctr = rays_ctr + active.sum()
        comb = traversal.Rays(*(torch.cat([a, b]) for a, b in zip(trace_rays, p_rays)))
        h2, it1, rw1, ov1 = traversal8.intersect_scene(
            geom, comb, with_iters=True, any_mask=amask)
        hit = traversal.Hit(t=h2.t[:B], tri=h2.tri[:B], u=h2.u[:B], v=h2.v[:B],
                            inst=None if h2.inst is None else h2.inst[:B])
        occluded_prev = h2.tri[B:] >= 0
        iters_ctr, rows_ctr, ovf_ctr = iters_ctr + it1, rows_ctr + rw1, ovf_ctr + ov1

        # ---- one path vertex for the active lanes (pt_radiance's bounce,
        # media-free) ----
        # the previous vertex's NEE resolves against this traversal
        L = L + torch.where((p_act & ~occluded_prev)[:, None], p_contrib, 0.0)
        miss = active & ~hit.valid
        env_le, w_env = pathmod._escaped(scene, cur.d, prev_pdf, prev_delta, use_nee)
        L = L + torch.where(miss[:, None], beta * env_le * w_env[:, None], 0.0)
        si = pathmod._surface(scene, geom, cur, hit, with_parallax, with_bump)
        alpha_pass, hit_l, state = pathmod._alpha_test(
            scene, si, active & hit.valid, state, with_alpha)
        le, w_hit = pathmod._emitted(scene, si, cur.o, prev_pdf, prev_delta, use_nee)
        L = L + torch.where(hit_l[:, None], beta * le * w_hit[:, None], 0.0)
        ctx, frame, wi_local = pathmod._shading(scene, si, hit, cur.d, cone,
                                                active_types, with_textures)
        if regularize:
            ctx = bsdfmod.regularize_ctx(ctx, had_smooth, regularize_alpha)
        if use_nee:
            ed, f_nee, pdf_nee, state = pathmod._nee_sample(
                scene, ctx, frame, wi_local, si.p, state, active_types)
            do_shadow = hit_l & ((pdf_nee + vm.length_sqr(f_nee)) > 0)
            p_rays = traversal.Rays(
                o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d, tmin=zero,
                tmax=torch.where(do_shadow, ed.dist * 0.999, 0.0))
            rays_ctr = rays_ctr + do_shadow.sum()
            contrib = pathmod._nee_contrib(beta, f_nee, pdf_nee, ed)
            p_contrib = torch.where(do_shadow[:, None], contrib, 0.0)
            p_act = hit_l
        else:
            p_rays = pathmod._dead_rays(B, dev)
            p_contrib = torch.zeros((B, 3), **f32)
            p_act = torch.zeros(B, dtype=torch.bool, device=dev)

        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types)
        wo_world = frame.to_world(s.wo)
        prev_delta = (s.sampled_type & records.T_DELTA) != 0
        prev_pdf = s.pdf
        weight = s.weight
        new_o = shading.offset_ray_origin(si.p, si.ng, wo_world)
        if with_alpha:
            wo_world, weight, prev_delta, new_o = pathmod._pass_through(
                alpha_pass, si, cur.d, wo_world, weight, prev_delta, new_o)
        beta_next = beta * weight
        cont = hit_l | alpha_pass
        alive = cont & (weight.abs().amax(dim=-1) > 0) & (depth + 1 < max_depth)
        state, beta_next, alive = pathmod._roulette(state, beta_next, alive,
                                                    depth >= rr_depth)
        had_smooth = had_smooth | (cont & ~prev_delta)
        cur = traversal.Rays(o=new_o, d=wo_world, tmin=zero, tmax=zero + 1e30)
        beta = torch.where(alive[:, None], beta_next, 0.0)
        # a path that stops here still owes its last NEE: the lane drains
        # for one iteration (fin) before it is added to the film and reused
        done = fin
        fin = active & ~alive
        active = alive
        depth = depth + 1

        # lanes that entered this iteration draining are complete (their L
        # was untouched above: every addition is masked by an active lane)
        film = filmmod.add_samples(film, px, py, L * wt, mask=done)

        # regenerate the freed lanes from the path queue (a prefix-sum rank
        # in place of the reference's global atomic counter)
        rank = torch.cumsum(done.to(torch.int32), 0, dtype=torch.int32) - 1
        qidx = qhead + rank
        take = done & (qidx < n_paths)
        qhead = qhead + done.sum(dtype=torch.int32)
        rays_n, px_n, py_n, state_n, wt_n = gen(torch.where(take, qidx, 0))
        t1 = take[:, None]
        cur = traversal.Rays(o=torch.where(t1, rays_n.o, cur.o),
                             d=torch.where(t1, rays_n.d, cur.d),
                             tmin=torch.where(take, rays_n.tmin, cur.tmin),
                             tmax=torch.where(take, rays_n.tmax, cur.tmax))
        L = torch.where(t1, 0.0, L)
        beta = torch.where(t1, 1.0, beta)
        active = active | take
        fin = fin & ~(take | done)
        prev_pdf = torch.where(take, 0.0, prev_pdf)
        prev_delta = prev_delta | take
        had_smooth = had_smooth & ~take
        state = torch.where(take, state_n, state)
        px, py = torch.where(take, px_n, px), torch.where(take, py_n, py)
        wt = torch.where(t1, wt_n, wt)
        depth = torch.where(take, 0, depth)
        # fresh lanes have no pending shadow ray: kill their slot
        p_rays = p_rays._replace(tmax=torch.where(take, 0.0, p_rays.tmax))
        p_act = p_act & ~take
        it += 1
    return film, rays_ctr, iters_ctr, rows_ctr, ovf_ctr, it, reads


class WavefrontPT(tracer.TracerBase):
    """Regenerating wavefront PT (reference WavefrontPathTracer). Computes
    ``path.PathTracer``'s estimator on media-free scenes; the lane pool
    stays full, so each traversal's fixed cost spreads over live rays.

    Counters as ``PathTracer``'s (int64): ``_rays_dev``, ``_iters_dev``,
    ``_rows_dev``, ``_ovf_dev`` (capped, overflowed); for the last pass
    ``last_pass_iters`` (loop iterations) and ``last_pass_host_reads``
    (exit tests read back: iterations + 1)."""

    def __init__(self, scene, width, height, max_depth: int = 8,
                 rr_depth: int = 3, use_nee: bool = True,
                 regularize: bool = False, spp_per_pass: int = 1,
                 lanes: int = 1 << 17, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, spp_per_pass=spp_per_pass,
                         seed=seed)
        if mediummod.has_media(scene.media):
            raise ValueError("WavefrontPT is the media-free fast path; use PathTracer")
        self.max_depth = max_depth
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        self.lanes = min(lanes, width * height * spp_per_pass)
        dev = scene.device
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._iters_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._rows_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._ovf_dev = torch.zeros(2, dtype=torch.int64, device=dev)
        self.last_pass_iters = 0
        self.last_pass_host_reads = 0
        self._kw = dict(w=width, h=height, lanes=self.lanes, spp=spp_per_pass,
                        max_depth=max_depth, rr_depth=rr_depth, use_nee=use_nee,
                        active_types=self.active_types,
                        with_alpha=bsdfmod.scene_has_alpha(scene),
                        with_bump=bsdfmod.scene_has_bump(scene),
                        with_parallax=bsdfmod.scene_has_parallax(scene),
                        regularize=regularize,
                        with_textures=bsdfmod.scene_texture_mask(scene))

    def render_pass(self, scene, film, pass_idx):
        (film, self._rays_dev, self._iters_dev, self._rows_dev, self._ovf_dev,
         self.last_pass_iters, self.last_pass_host_reads) = _wf_pass(
            scene, film, self._rays_dev, self._iters_dev, self._rows_dev,
            self._ovf_dev, pass_idx + (self.seed << 16), **self._kw)
        return film

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)
