"""Wavefront path tracer with NEE, power-heuristic MIS, and Russian roulette.

Port of ``cudatracerlib_tpu/models/path.py``. The lane batch advances bounce
by bounce in a Python loop; inactive lanes carry tmax=0 rays. Each bounce
traces ONE mixed wavefront: this bounce's closest-hit rays together with
the previous bounce's NEE shadow rays (per-lane any-hit, ``any_mask``), the
reference's deferred shadow-ray queue. The last bounce's shadow rays are
traced after the loop.

Not ported yet (they raise): media, alpha, bump, parallax, BSSRDF,
spectral transport, sequence samplers and regularization.

The ray, iteration and row counters are int64 tensors: one 512x512 pass at
depth 6 traces millions of rays, past float32's exact integers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import mis
from ..core import records
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import tracer

Tensor = torch.Tensor


def _unported(**flags):
    on = [k for k, v in flags.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


def pt_radiance(scene: schema.SceneData, rays: traversal.Rays, state: Tensor,
                max_depth: int = 8, rr_depth: int = 3, use_nee: bool = True,
                active_types: Sequence[int] = bsdfmod.PORTED_TYPES,
                with_media: bool | None = None, with_alpha: bool = False,
                with_bump: bool = False, with_parallax: bool = False,
                with_bssrdf: bool = False, regularize: bool = False,
                regularize_alpha: float = 0.08, with_textures: bool = True,
                return_rays: bool = False, sampler_type: int = 0,
                pixel_idx: Tensor = None, sample_idx=0, spectral: int = 0):
    """Estimate radiance along each lane's camera ray. Returns (L, state), or
    with return_rays (L, state, rays, iters, rows, ovf): int64 counters of
    live rays traced, traversal steps, 512-byte rows read, and the (2,)
    capped / stack-overflowed ray counts."""
    if with_media is None:
        with_media = int(schema.host_meta(scene)["n_media"]) > 0
    _unported(with_media=with_media, with_alpha=with_alpha,
              with_bump=with_bump, with_parallax=with_parallax,
              with_bssrdf=with_bssrdf, regularize=regularize,
              sampler_type=sampler_type, spectral=spectral)
    B, dev = rays.o.shape[0], rays.o.device
    geom = scene.geom
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(B, **f32)
    L = torch.zeros((B, 3), **f32)
    beta = torch.ones((B, 3), **f32)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    prev_pdf = zero
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)  # camera rays: weight 1
    cur = rays
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    niters = torch.zeros((), dtype=torch.int64, device=dev)
    nrows = torch.zeros((), dtype=torch.int64, device=dev)
    novf = torch.zeros(2, dtype=torch.int64, device=dev)
    # ray-cone angular width: one pixel of the sensor (grows linearly with t)
    params = scene.sensor.params
    cone = 2.0 * torch.tan(0.5 * params[0]) / params[5].clamp_min(1.0)
    # camera rays are the one coherent wavefront of a path: on a treelet
    # table they get the larger coherent visit budget
    peel_coherent = (max_depth > 0
                     and traversal8.treelet_would_dispatch(geom, coherent=True))
    merge = use_nee
    if merge:
        # empty pending-shadow queue: dead rays (tmax=0) with a valid dir
        p_contrib = torch.zeros((B, 3), **f32)
        p_rays = traversal.Rays(
            o=torch.zeros((B, 3), **f32),
            d=torch.tensor([0.0, 0.0, 1.0], **f32).expand(B, 3).contiguous(),
            tmin=zero, tmax=zero)
        p_act = torch.zeros(B, dtype=torch.bool, device=dev)
        amask = torch.cat([torch.zeros(B, dtype=torch.bool, device=dev),
                           torch.ones(B, dtype=torch.bool, device=dev)])

    for depth in range(max_depth):
        coherent = peel_coherent and depth == 0
        trace_rays = traversal.Rays(o=cur.o, d=cur.d, tmin=cur.tmin,
                                    tmax=torch.where(active, cur.tmax, 0.0))
        nrays = nrays + active.sum()
        if merge:
            comb = traversal.Rays(
                o=torch.cat([trace_rays.o, p_rays.o]),
                d=torch.cat([trace_rays.d, p_rays.d]),
                tmin=torch.cat([trace_rays.tmin, p_rays.tmin]),
                tmax=torch.cat([trace_rays.tmax, p_rays.tmax]))
            h2, it1, rw1, ov1 = traversal8.intersect_scene(
                geom, comb, with_iters=True, coherent=coherent, any_mask=amask)
            hit = traversal.Hit(t=h2.t[:B], tri=h2.tri[:B],
                                u=h2.u[:B], v=h2.v[:B])
            occluded_prev = h2.tri[B:] >= 0
            L = L + torch.where((p_act & ~occluded_prev)[:, None], p_contrib, 0.0)
        else:
            hit, it1, rw1, ov1 = traversal8.intersect_scene(
                geom, trace_rays, with_iters=True, coherent=coherent)
        niters = niters + it1
        nrows = nrows + rw1
        novf = novf + ov1

        miss = active & ~hit.valid

        # --- escaped rays: environment ---
        env_le = lightsmod.eval_environment(scene, cur.d)
        if use_nee:
            pdf_env = lightsmod.pdf_env_direct(scene, cur.d)
            w_env = torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_env))
        else:
            w_env = torch.ones(B, **f32)
        L = L + torch.where(miss[:, None], beta * env_le * w_env[:, None], 0.0)

        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        hit_l = active & hit.valid

        # --- emitted radiance at the hit (area lights) with MIS ---
        le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
        if use_nee:
            pdf_l = lightsmod.pdf_hit_emitter_direct(scene, si.light_id, cur.o,
                                                     si.p, si.ng)
            w_hit = torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_l))
        else:
            w_hit = torch.ones(B, **f32)
        L = L + torch.where(hit_l[:, None], beta * le * w_hit[:, None], 0.0)

        # --- surface shading setup: the texture footprint of the ray cone
        # (only textured scenes read it; XLA drops it for the others) ---
        footprint = ewa = None
        if with_textures:
            footprint = cone * hit.t * si.uv_density
            # EWA anisotropy: the pixel footprint stretches by 1/cos(theta)
            # at grazing incidence along the view direction's tangent
            # projection
            cos_v = vm.dot(si.ns, cur.d).abs()
            major = footprint / cos_v.clamp(0.125, 1.0)
            d_t = vm.dot(cur.d, si.frame_t)
            d_s = vm.dot(cur.d, si.frame_s)
            d_len = torch.sqrt((d_t * d_t + d_s * d_s).clamp_min(1e-12))
            ewa = (torch.stack([d_t / d_len, d_s / d_len], -1), major)
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, footprint,
                                 active_types=active_types,
                                 with_textures=with_textures,
                                 ewa=ewa, extra=si.extra)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)

        # --- next-event estimation; occlusion resolves in the next bounce's
        # merged traversal ---
        if use_nee:
            ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
            lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), active_types)
            shadow_o = shading.offset_ray_origin(si.p, si.ng, ed.d)
            do_shadow = hit_l & ((lob.pdf + vm.length_sqr(lob.f)) > 0)
            shadow = traversal.Rays(
                o=shadow_o, d=ed.d, tmin=zero,
                tmax=torch.where(do_shadow, ed.dist * 0.999, 0.0))
            nrays = nrays + do_shadow.sum()
            w_nee = torch.where(ed.is_delta, 1.0, mis.power_heuristic(ed.pdf, lob.pdf))
            contrib = beta * (lob.f * ed.radiance_over_pdf) * w_nee[:, None]
            p_contrib = torch.where(do_shadow[:, None], contrib, 0.0)
            p_rays = shadow
            p_act = hit_l

        # --- continue the path: BSDF sample ---
        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types)
        wo_world = frame.to_world(s.wo)
        is_delta = (s.sampled_type & records.T_DELTA) != 0
        weight = s.weight
        new_o = shading.offset_ray_origin(si.p, si.ng, wo_world)
        beta_next = beta * weight
        alive = hit_l & (weight.abs().amax(dim=-1) > 0) & (depth + 1 < max_depth)

        # --- Russian roulette on throughput ---
        state, u_rr = rngmod.next_float(state)
        if depth >= rr_depth:
            q = beta_next.amax(dim=-1).clamp(0.05, 0.95)
            survive = u_rr < q
            beta_next = torch.where(survive[:, None],
                                    beta_next / q.clamp_min(1e-6)[:, None], beta_next)
            alive = alive & survive

        cur = traversal.Rays(o=new_o, d=wo_world, tmin=zero, tmax=zero + 1e30)
        beta = torch.where(alive[:, None], beta_next, 0.0)
        active = alive
        prev_pdf = s.pdf
        prev_delta = is_delta

    if merge:
        # resolve the LAST bounce's pending shadow queue
        occ_hit, itf, rwf, ovf_ = traversal8.intersect_scene(
            geom, p_rays, any_hit=True, with_iters=True)
        L = L + torch.where((p_act & ~occ_hit.valid)[:, None], p_contrib, 0.0)
        niters = niters + itf
        nrows = nrows + rwf
        novf = novf + ovf_
    if return_rays:
        return L, state, nrays, niters, nrows, novf
    return L, state


class PathTracer(tracer.TracerBase):
    """Progressive unidirectional path tracer (reference PathTracer).

    The scene's device is the tracer's (``DynamicScene.build`` puts it on
    the card unless asked for the CPU)."""

    def __init__(self, scene, width, height, max_depth: int = 8,
                 rr_depth: int = 3, use_nee: bool = True, regularize: bool = False,
                 spp_per_pass: int = 1, chunk_size: int = 1 << 17, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None,
                 sampler_type: int = 0, spectral: int = 0):
        super().__init__(scene, width, height, spp_per_pass=spp_per_pass, seed=seed)
        _unported(regularize=regularize, sampler_type=sampler_type,
                  spectral=spectral, alpha=bsdfmod.scene_has_alpha(scene),
                  bump=bsdfmod.scene_has_bump(scene))
        self.max_depth = max_depth
        if active_types is None:
            active_types = scene_active_types(scene)
        self.active_types = tuple(active_types)
        self.with_textures = bsdfmod.scene_texture_mask(scene)
        self.chunk_size = min(chunk_size, width * height)
        self._n_chunks = (width * height + self.chunk_size - 1) // self.chunk_size
        dev = scene.device
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._iters_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._rows_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._ovf_dev = torch.zeros(2, dtype=torch.int64, device=dev)  # capped, overflowed
        self._chunk_kw = dict(
            w=width, h=height, chunk=self.chunk_size,
            max_depth=max_depth, rr_depth=rr_depth, use_nee=use_nee,
            spp=spp_per_pass, active_types=self.active_types,
            with_textures=self.with_textures)

    def render_pass(self, scene, film, pass_idx):
        for c in range(self._n_chunks):
            # the tracer seed offsets the pass index so differently-seeded
            # tracers draw decorrelated streams
            (film, self._rays_dev, self._iters_dev, self._rows_dev,
             self._ovf_dev) = _pt_chunk(
                    scene, film, self._rays_dev, self._iters_dev,
                    self._rows_dev, self._ovf_dev,
                    pass_idx + (self.seed << 16), c, **self._chunk_kw)
        return film

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)


def scene_active_types(scene: schema.SceneData):
    """Static tuple of BSDF types present in the scene."""
    return tuple(sorted(set(schema.host_meta(scene)["mat_type"].tolist())))


def _pt_chunk(scene: schema.SceneData, film: filmmod.Film, rays_ctr,
              iters_ctr, rows_ctr, ovf_ctr, pass_idx, chunk_idx,
              w: int, h: int, chunk: int, max_depth: int, rr_depth: int,
              use_nee: bool, spp: int, active_types, with_alpha: bool = False,
              with_bump: bool = False, with_parallax: bool = False,
              with_bssrdf: bool = False, regularize: bool = False,
              with_textures: bool = True, sampler_type: int = 0,
              spectral: int = 0):
    """One chunk of one pass: `chunk` lanes from pixel chunk_idx*chunk on,
    `spp` samples each, added into `film`. Returns the film and the
    counters advanced by this chunk."""
    dev = film.rgb.device
    base = (chunk_idx * chunk) % (w * h)
    pixel_idx = (base + torch.arange(chunk, dtype=torch.int32, device=dev)) % (w * h)
    for s_i in range(spp):
        sample_idx = pass_idx * spp + s_i
        rays, px, py, state, wt = tracer.gen_camera_rays(
            scene, pixel_idx, sample_idx, pass_idx, w, h,
            sampler_type=sampler_type)
        L, state, nr, ni, nw, nv = pt_radiance(
            scene, rays, state, max_depth, rr_depth,
            use_nee, active_types, with_alpha=with_alpha,
            with_bump=with_bump, with_parallax=with_parallax,
            with_bssrdf=with_bssrdf, regularize=regularize,
            with_textures=with_textures, return_rays=True,
            sampler_type=sampler_type, pixel_idx=pixel_idx,
            sample_idx=sample_idx, spectral=spectral)
        rays_ctr = rays_ctr + nr
        iters_ctr = iters_ctr + ni
        rows_ctr = rows_ctr + nw
        ovf_ctr = ovf_ctr + nv
        film = filmmod.add_samples(film, px, py, L * wt)
    return film, rays_ctr, iters_ctr, rows_ctr, ovf_ctr
