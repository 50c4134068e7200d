"""Wavefront path tracer with NEE, power-heuristic MIS, and Russian roulette.

Port of ``cudatracerlib_tpu/models/path.py``. The lane batch advances bounce
by bounce in a Python loop; inactive lanes carry tmax=0 rays. Each bounce
traces ONE mixed wavefront: this bounce's closest-hit rays together with
the previous bounce's NEE shadow rays (per-lane any-hit, ``any_mask``), the
reference's deferred shadow-ray queue. The last bounce's shadow rays are
traced after the loop.

With media (``models/medium.py``) each segment samples a medium
interaction by delta tracking, NEE runs from surface and medium vertices
alike, and medium vertices continue by sampling the phase function. The
shadow rays are then not merged: as in the JAX package, each bounce traces
them (any hit) within the bounce and estimates the transmittance of the
unoccluded ones by ratio tracking, drawing the same uniforms in the same
order.

Not ported yet (they raise): alpha, bump, parallax, BSSRDF, spectral
transport, sequence samplers and regularization.

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
from . import medium as mediummod
from . import phase as phasemod
from . import tracer

Tensor = torch.Tensor


def _unported(**flags):
    on = [k for k, v in flags.items() if v]
    if on:
        raise NotImplementedError(f"not ported yet: {', '.join(on)}")


def _dead_rays(B: int, dev) -> traversal.Rays:
    """Rays that trace nothing (tmax 0) with a valid direction."""
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(B, **f32)
    return traversal.Rays(o=torch.zeros((B, 3), **f32),
                          d=torch.tensor([0.0, 0.0, 1.0], **f32).expand(B, 3).contiguous(),
                          tmin=zero, tmax=zero)


def _escaped(scene, d, prev_pdf, prev_delta, use_nee: bool):
    """(environment radiance, MIS weight) of rays escaping along d."""
    env_le = lightsmod.eval_environment(scene, d)
    if not use_nee:
        return env_le, torch.ones_like(prev_pdf)
    pdf_env = lightsmod.pdf_env_direct(scene, d)
    return env_le, torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_env))


def _emitted(scene, si, o, prev_pdf, prev_delta, use_nee: bool):
    """(emitted radiance, MIS weight) at the hit si of rays from o."""
    le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
    if not use_nee:
        return le, torch.ones_like(prev_pdf)
    pdf_l = lightsmod.pdf_hit_emitter_direct(scene, si.light_id, o, si.p, si.ng)
    return le, torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_l))


def _shading(scene, si, hit, d, cone, active_types, with_textures):
    """The BSDF context at the hit, with the texture footprint of the ray
    cone (textured scenes only), its frame and the local incoming
    direction: (ctx, frame, wi_local)."""
    footprint = ewa = None
    if with_textures:
        footprint = cone * hit.t * si.uv_density
        # EWA anisotropy: the pixel footprint stretches by 1/cos(theta) at
        # grazing incidence along the view direction's tangent projection
        cos_v = vm.dot(si.ns, d).abs()
        major = footprint / cos_v.clamp(0.125, 1.0)
        d_t = vm.dot(d, si.frame_t)
        d_s = vm.dot(d, si.frame_s)
        d_len = torch.sqrt((d_t * d_t + d_s * d_s).clamp_min(1e-12))
        ewa = (torch.stack([d_t / d_len, d_s / d_len], -1), major)
    ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, footprint,
                             active_types=active_types,
                             with_textures=with_textures, ewa=ewa, extra=si.extra)
    frame = si.frame()
    return ctx, frame, frame.to_local(si.wi)


def _nee_sample(scene, ctx, frame, wi_local, p, state, active_types):
    """Sample an emitter from p and evaluate the BSDF toward it:
    (EmitterDirect, f, pdf, state)."""
    ed, state = lightsmod.sample_emitter_direct(scene, p, state)
    lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), active_types)
    return ed, lob.f, lob.pdf, state


def _nee_contrib(beta, f, pdf, ed):
    """The unoccluded NEE contribution with the power heuristic."""
    w_nee = torch.where(ed.is_delta, 1.0, mis.power_heuristic(ed.pdf, pdf))
    return beta * (f * ed.radiance_over_pdf) * w_nee[:, None]


def _roulette(state, beta_next, alive, do_rr):
    """Russian roulette on throughput: draws one uniform per lane; `do_rr`
    is a Python bool (a bounce of the lockstep batch) or a per-lane bool
    tensor (the wavefront's lanes at their own depths). Returns (state,
    beta_next, alive)."""
    state, u_rr = rngmod.next_float(state)
    if do_rr is False:
        return state, beta_next, alive
    q = beta_next.amax(dim=-1).clamp(0.05, 0.95)
    survive = u_rr < q
    scale = survive
    if do_rr is not True:
        scale = survive & do_rr
        survive = survive | ~do_rr
    beta_next = torch.where(scale[:, None],
                            beta_next / q.clamp_min(1e-6)[:, None], beta_next)
    return state, beta_next, alive & survive


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
        with_media = mediummod.has_media(scene.media)
    _unported(with_alpha=with_alpha,
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
    # media need the occlusion within the bounce (transmittance sampling
    # order), so they take the unmerged route
    merge = use_nee and not with_media
    if merge:
        # empty pending-shadow queue
        p_contrib = torch.zeros((B, 3), **f32)
        p_rays = _dead_rays(B, dev)
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

        # --- medium interaction on this segment? ---
        if with_media:
            t_seg = torch.where(hit.valid, hit.t * 0.999, 1e7)
            ms, state = mediummod.sample_distance(scene.media, cur.o, cur.d,
                                                  t_seg, state, active)
            beta = beta * ms.weight
            med_event = ms.valid
        else:
            med_event = torch.zeros(B, dtype=torch.bool, device=dev)

        miss = active & ~hit.valid & ~med_event

        # --- escaped rays: environment ---
        env_le, w_env = _escaped(scene, cur.d, prev_pdf, prev_delta, use_nee)
        L = L + torch.where(miss[:, None], beta * env_le * w_env[:, None], 0.0)

        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        hit_l = active & hit.valid & ~med_event

        # --- emitted radiance at the hit (area lights) with MIS ---
        le, w_hit = _emitted(scene, si, cur.o, prev_pdf, prev_delta, use_nee)
        L = L + torch.where(hit_l[:, None], beta * le * w_hit[:, None], 0.0)

        # --- surface shading setup ---
        ctx, frame, wi_local = _shading(scene, si, hit, cur.d, cone,
                                        active_types, with_textures)

        # --- next-event estimation (surface and medium vertices jointly);
        # without media, occlusion resolves in the next bounce's merged
        # traversal ---
        if use_nee:
            nee_active = hit_l | med_event
            nee_p = torch.where(med_event[:, None], ms.p, si.p) if with_media else si.p
            ed, f_nee, pdf_fwd, state = _nee_sample(scene, ctx, frame, wi_local,
                                                    nee_p, state, active_types)
            shadow_o = shading.offset_ray_origin(si.p, si.ng, ed.d)
            if with_media:
                ph = phasemod.eval_phase(ms.ptype, ms.g, cur.d, ed.d)
                ph_pdf = phasemod.pdf_phase(ms.ptype, ms.g, cur.d, ed.d)
                f_nee = torch.where(med_event[:, None], ph[:, None], f_nee)
                pdf_fwd = torch.where(med_event, ph_pdf, pdf_fwd)
                shadow_o = torch.where(med_event[:, None], nee_p, shadow_o)
            do_shadow = nee_active & ((pdf_fwd + vm.length_sqr(f_nee)) > 0)
            shadow = traversal.Rays(
                o=shadow_o, d=ed.d, tmin=zero,
                tmax=torch.where(do_shadow, ed.dist * 0.999, 0.0))
            nrays = nrays + do_shadow.sum()
            contrib = _nee_contrib(beta, f_nee, pdf_fwd, ed)
            if merge:
                p_contrib = torch.where(do_shadow[:, None], contrib, 0.0)
                p_rays = shadow
                p_act = nee_active
            else:
                occ_hit, it2, rw2, ov2 = traversal8.intersect_scene(
                    geom, shadow, any_hit=True, with_iters=True)
                occluded = occ_hit.valid
                niters = niters + it2
                nrows = nrows + rw2
                novf = novf + ov2
                if with_media:
                    Tr, state = mediummod.transmittance(
                        scene.media, shadow_o, ed.d, ed.dist * 0.999, state,
                        do_shadow & ~occluded)
                    contrib = contrib * Tr
                L = L + torch.where((nee_active & ~occluded)[:, None], contrib, 0.0)

        # --- continue the path: BSDF sample ---
        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types)
        wo_world = frame.to_world(s.wo)
        is_delta = (s.sampled_type & records.T_DELTA) != 0
        weight = s.weight
        next_pdf = s.pdf
        new_o = shading.offset_ray_origin(si.p, si.ng, wo_world)
        if with_media:
            # medium vertices continue by sampling the phase function
            state, u_ph = rngmod.next_float2(state)
            wo_ph, w_ph, pdf_ph = phasemod.sample_phase(ms.ptype, ms.g, cur.d, u_ph)
            wo_world = torch.where(med_event[:, None], wo_ph, wo_world)
            weight = torch.where(med_event[:, None], w_ph[:, None], weight)
            next_pdf = torch.where(med_event, pdf_ph, next_pdf)
            is_delta = torch.where(med_event, False, is_delta)
            new_o = torch.where(med_event[:, None], ms.p, new_o)
        beta_next = beta * weight
        alive = ((hit_l | med_event) & (weight.abs().amax(dim=-1) > 0)
                 & (depth + 1 < max_depth))

        # --- Russian roulette on throughput ---
        state, beta_next, alive = _roulette(state, beta_next, alive,
                                            depth >= rr_depth)

        cur = traversal.Rays(o=new_o, d=wo_world, tmin=zero, tmax=zero + 1e30)
        beta = torch.where(alive[:, None], beta_next, 0.0)
        active = alive
        prev_pdf = next_pdf
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
