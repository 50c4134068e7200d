"""Wavefront path tracer with NEE, power-heuristic MIS, and Russian roulette.

Port of ``cudatracerlib_tpu/models/path.py``. The lane batch advances bounce
by bounce in a Python loop; inactive lanes carry tmax=0 rays. Each bounce
traces ONE mixed wavefront: this bounce's closest-hit rays together with
the previous bounce's NEE shadow rays (per-lane any-hit, ``any_mask``), the
reference's deferred shadow-ray queue. The last bounce's shadow rays are
traced after the loop.

With media (``models/medium.py``) each segment samples a medium
interaction by delta tracking, NEE runs from surface and medium vertices
alike, and medium vertices continue by sampling the phase function. With
a subsurface (BSSRDF) material, lanes inside it random-walk through its
homogeneous medium. Both take the unmerged shadow route: as in the JAX
package, each bounce traces its shadow rays (any hit) within the bounce,
and with media estimates the transmittance of the unoccluded ones by ratio
tracking, drawing the same uniforms in the same order.

The bounce also takes alpha masks (a stochastic pass-through), bump and
parallax mapping, the stratified and Sobol' sequences for the NEE and BSDF
dimensions (``models/samplers.py``), and hero-wavelength spectral transport
(``spectral=C``: L and beta carry C wavelengths, RGB factors are upsampled
on the fly, and the result resolves to RGB at the end), and path
regularization (``regularize``: once a path has taken a smooth bounce, its
delta dielectrics and conductors turn rough, bsdf.regularize_ctx).

The ray, iteration and row counters are int64 tensors: one 512x512 pass at
depth 6 traces millions of rays, past float32's exact integers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import mis
from ..core import records
from ..core import rng as rngmod
from ..core import spectrum as specmod
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema
from ..utils import timers
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import medium as mediummod
from . import phase as phasemod
from . import samplers
from . import tracer

Tensor = torch.Tensor

_TRANSMISSION = (records.T_DELTA_TRANSMISSION | records.T_GLOSSY_TRANSMISSION
                 | records.T_DIFFUSE_TRANSMISSION)


def _dead_rays(B: int, dev) -> traversal.Rays:
    """Rays that trace nothing (tmax 0) with a valid direction."""
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(B, **f32)
    return traversal.Rays(o=torch.zeros((B, 3), **f32),
                          d=torch.tensor([0.0, 0.0, 1.0], **f32).expand(B, 3).contiguous(),
                          tmin=zero, tmax=zero)


def _rgb(c3):
    return c3


def _escaped(scene, d, prev_pdf, prev_delta, use_nee: bool, up=_rgb):
    """(environment radiance, MIS weight) of rays escaping along d; `up`
    upsamples the radiance to the path's channels (spectral transport)."""
    env_le = up(lightsmod.eval_environment(scene, d))
    if not use_nee:
        return env_le, torch.ones_like(prev_pdf)
    pdf_env = lightsmod.pdf_env_direct(scene, d)
    return env_le, torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_env))


def _emitted(scene, si, o, prev_pdf, prev_delta, use_nee: bool, up=_rgb):
    """(emitted radiance, MIS weight) at the hit si of rays from o."""
    le = up(lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi))
    if not use_nee:
        return le, torch.ones_like(prev_pdf)
    pdf_l = lightsmod.pdf_hit_emitter_direct(scene, si.light_id, o, si.p, si.ng)
    return le, torch.where(prev_delta, 1.0, mis.power_heuristic(prev_pdf, pdf_l))


def _surface(scene, geom, rays, hit, with_parallax, with_bump):
    """The hit's differential geometry, with parallax and bump mapping
    applied where the scene has them."""
    si = shading.fill_dg(geom, rays, hit, flip_to_ray=False)
    if with_parallax:
        si = bsdfmod.apply_parallax(scene, si)
    if with_bump:
        si = bsdfmod.apply_bump(scene, si)
    return si


def _alpha_test(scene, si, hit_l, state, with_alpha):
    """The stochastic alpha test: draws one uniform per lane (alpha scenes
    only); returns (lanes that pass through, hit_l without them, state)."""
    if not with_alpha:
        return torch.zeros_like(hit_l), hit_l, state
    a = bsdfmod.eval_alpha(scene, si.mat_id, si.uv)
    state, u_a = rngmod.next_float(state)
    alpha_pass = hit_l & (u_a >= a)
    return alpha_pass, hit_l & ~alpha_pass, state


def _pass_through(alpha_pass, si, d, wo_world, weight, is_delta, new_o):
    """Alpha pass-through lanes continue along d from just past the hit,
    with weight 1 (a delta event)."""
    ap = alpha_pass[:, None]
    return (torch.where(ap, d, wo_world), torch.where(ap, 1.0, weight),
            torch.where(alpha_pass, True, is_delta),
            torch.where(ap, si.p + d * 1e-4, new_o))


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


def _nee_sample(scene, ctx, frame, wi_local, p, state, active_types,
                u_override=None, override_mask=None):
    """Sample an emitter from p (lanes of override_mask with the uniforms
    u_override) and evaluate the BSDF toward it: (EmitterDirect, f, pdf,
    state)."""
    ed, state = lightsmod.sample_emitter_direct(scene, p, state, u_override,
                                                override_mask)
    lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), active_types)
    return ed, lob.f, lob.pdf, state


def _nee_contrib(beta, f, pdf, ed, up=_rgb):
    """The unoccluded NEE contribution with the power heuristic."""
    w_nee = torch.where(ed.is_delta, 1.0, mis.power_heuristic(ed.pdf, pdf))
    return beta * up(f * ed.radiance_over_pdf) * w_nee[:, None]


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


def _seq_dims(sampler_type, pixel_idx, sample_idx, dim0):
    """(B, 3) sequence uniforms of dimensions dim0..dim0+2 (the span
    ``ctl.sampler``)."""
    with timers.span("ctl.sampler"):
        return torch.stack([samplers.sample_1d_dyn(sampler_type, pixel_idx,
                                                   sample_idx, dim0 + j)
                            for j in range(3)], -1)


def pt_radiance(scene: schema.SceneData, rays: traversal.Rays, state: Tensor,
                max_depth: int = 8, rr_depth: int = 3, use_nee: bool = True,
                active_types: Sequence[int] = bsdfmod.ALL_TYPES,
                with_media: bool | None = None, with_alpha: bool = False,
                with_bump: bool = False, with_parallax: bool = False,
                with_bssrdf: bool = False, regularize: bool = False,
                regularize_alpha: float = 0.08, with_textures: bool = True,
                return_rays: bool = False, sampler_type: int = 0,
                pixel_idx: Tensor = None, sample_idx=0, spectral: int = 0):
    """Estimate radiance along each lane's camera ray. Returns (L, state), or
    with return_rays (L, state, rays, iters, rows, ovf): int64 counters of
    live rays traced, traversal steps, 512-byte rows read, and the (2,)
    capped / stack-overflowed ray counts.

    spectral > 0 switches to hero-wavelength transport with that many
    stratified wavelengths per path; the returned L is linear RGB either
    way. With sampler_type != 0 and pixel_idx given, depth d draws its NEE
    uniforms from sequence dimensions 4+6d..6+6d and its BSDF uniforms from
    7+6d..9+6d (sample index sample_idx). With regularize, the BSDF of a
    lane that has taken a smooth bounce is regularized (bsdf.regularize_ctx
    with regularize_alpha); active_types must then hold
    bsdf.REGULARIZE_EXTRA_TYPES, as PathTracer's do.

    A bounce's stages are spans of ``utils/timers.RECORDER``: ``ctl.surface``
    (the BSSRDF walk, media, escaped rays, the hit's geometry, emission and
    BSDF context), ``ctl.nee`` and ``ctl.bsdf`` (the sample through Russian
    roulette and the next ray); the traversals are ``ctl.traverse``."""
    if with_media is None:
        with_media = mediummod.has_media(scene.media)
    B, dev = rays.o.shape[0], rays.o.device
    geom = scene.geom
    f32 = dict(dtype=torch.float32, device=dev)
    C = int(spectral)
    up = _rgb
    if C:
        state, u_lam = rngmod.next_float(state)
        lam, _ = specmod.sample_hero_wavelengths(u_lam, C)     # (B, C)

        def up(c3):
            return specmod.rgb_to_spectral(c3, lam)
    zero = torch.zeros(B, **f32)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    L = torch.zeros((B, C or 3), **f32)
    beta = torch.ones((B, C or 3), **f32)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    prev_pdf = zero
    prev_delta = torch.ones(B, dtype=torch.bool, device=dev)  # camera rays: weight 1
    had_smooth = false             # a non-delta bounce happened (regularization)
    ins_med = false                # inside a subsurface material
    ins_mat = torch.zeros(B, dtype=torch.int32, device=dev)
    mono_done = false              # spectral: the path went monochromatic
    cur = rays
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    niters = torch.zeros((), dtype=torch.int64, device=dev)
    nrows = torch.zeros((), dtype=torch.int64, device=dev)
    novf = torch.zeros(2, dtype=torch.int64, device=dev)
    # ray-cone angular width: one pixel of the sensor (grows linearly with t)
    params = scene.sensor.params
    cone = 2.0 * torch.tan(0.5 * params[0]) / params[5].clamp_min(1.0)
    use_seq = sampler_type != 0 and pixel_idx is not None
    # camera rays are the one coherent wavefront of a path: on a treelet
    # table they get the larger coherent visit budget
    peel_coherent = (max_depth > 0
                     and traversal8.treelet_would_dispatch(geom, coherent=True))
    # media and the BSSRDF walk need the occlusion within the bounce
    # (transmittance sampling order), so they take the unmerged route
    merge = use_nee and not with_media and not with_bssrdf
    if merge:
        # empty pending-shadow queue
        p_contrib = torch.zeros((B, C or 3), **f32)
        p_rays = _dead_rays(B, dev)
        p_act = false
        amask = torch.cat([false, ~false])
    if with_bssrdf:
        mp = scene.materials.params
        n_mat = mp.shape[0]

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
                                u=h2.u[:B], v=h2.v[:B],
                                inst=None if h2.inst is None else h2.inst[:B])
            occluded_prev = h2.tri[B:] >= 0
            L = L + torch.where((p_act & ~occluded_prev)[:, None], p_contrib, 0.0)
        else:
            hit, it1, rw1, ov1 = traversal8.intersect_scene(
                geom, trace_rays, with_iters=True, coherent=coherent)
        niters = niters + it1
        nrows = nrows + rw1
        novf = novf + ov1

        with timers.span("ctl.surface"):
            # --- BSSRDF random walk: lanes inside a subsurface material sample
            # a homogeneous scattering distance against the surface exit;
            # scatter events redirect the walk with the material's HG phase ---
            if with_bssrdf:
                imx = ins_mat.clamp(0, n_mat - 1).long()
                sa_b = mp[imx, 25:28]
                ss_b = mp[imx, 28:31]
                g_b = mp[imx, 31]
                sig_tb = sa_b + ss_b
                sbar = sig_tb.mean(-1).clamp_min(1e-6)
                state, u_b = rngmod.next_float(state)
                t_s = -torch.log((1.0 - u_b).clamp_min(1e-9)) / sbar
                t_exit = torch.where(hit.valid, hit.t, 1e7)
                bss_scatter = ins_med & active & (t_s < t_exit)
                bss_through = ins_med & active & ~bss_scatter
                pdf_sc = sbar * torch.exp(-sbar * t_s)
                w_sc = ss_b * torch.exp(-sig_tb * t_s[:, None]) / pdf_sc.clamp_min(1e-20)[:, None]
                w_th = (torch.exp(-sig_tb * t_exit[:, None])
                        / torch.exp(-sbar * t_exit).clamp_min(1e-20)[:, None])
                beta = torch.where(bss_scatter[:, None], beta * up(w_sc),
                                   torch.where(bss_through[:, None], beta * up(w_th), beta))
                bss_p = cur.o + cur.d * t_s[:, None]
            else:
                bss_scatter = false

            # --- medium interaction on this segment? ---
            if with_media:
                t_seg = torch.where(hit.valid, hit.t * 0.999, 1e7)
                ms, state = mediummod.sample_distance(scene.media, cur.o, cur.d,
                                                      t_seg, state, active)
                beta = beta * up(ms.weight)
                med_event = ms.valid
            else:
                med_event = false

            miss = active & ~hit.valid & ~med_event
            if with_bssrdf:
                miss = miss & ~ins_med

            # --- escaped rays: environment ---
            env_le, w_env = _escaped(scene, cur.d, prev_pdf, prev_delta, use_nee, up)
            L = L + torch.where(miss[:, None], beta * env_le * w_env[:, None], 0.0)

            si = _surface(scene, geom, trace_rays, hit, with_parallax, with_bump)
            hit_l = active & hit.valid & ~med_event & ~bss_scatter
            # stochastic alpha test: transparent lanes pass straight through
            alpha_pass, hit_l, state = _alpha_test(scene, si, hit_l, state, with_alpha)

            # --- emitted radiance at the hit (area lights) with MIS ---
            le, w_hit = _emitted(scene, si, cur.o, prev_pdf, prev_delta, use_nee, up)
            L = L + torch.where(hit_l[:, None], beta * le * w_hit[:, None], 0.0)

            # --- surface shading setup ---
            ctx, frame, wi_local = _shading(scene, si, hit, cur.d, cone,
                                            active_types, with_textures)
            if C:
                # hero-wavelength dispersion: dielectrics refract with the
                # continuous eta(lambda_hero) (nm -> um)
                ctx = ctx._replace(lam_um=lam[:, 0] * 1e-3)
            if regularize:
                ctx = bsdfmod.regularize_ctx(ctx, had_smooth, regularize_alpha)

        with timers.span("ctl.nee"):
            # --- next-event estimation (surface and medium vertices jointly);
            # merged, occlusion resolves in the next bounce's traversal ---
            if use_nee:
                nee_active = hit_l | med_event
                if with_bssrdf:      # inside lanes: light arrives via the walk only
                    nee_active = nee_active & ~ins_med
                nee_p = torch.where(med_event[:, None], ms.p, si.p) if with_media else si.p
                u_nee = (_seq_dims(sampler_type, pixel_idx, sample_idx, 4 + 6 * depth)
                         if use_seq else None)
                ed, f_nee, pdf_fwd, state = _nee_sample(
                    scene, ctx, frame, wi_local, nee_p, state, active_types,
                    u_nee, nee_active)
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
                contrib = _nee_contrib(beta, f_nee, pdf_fwd, ed, up)
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
                        contrib = contrib * up(Tr)
                    L = L + torch.where((nee_active & ~occluded)[:, None], contrib, 0.0)

        with timers.span("ctl.bsdf"):
            # --- continue the path: BSDF sample ---
            u_bsdf = (_seq_dims(sampler_type, pixel_idx, sample_idx, 7 + 6 * depth)
                      if use_seq else None)
            s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types,
                                               u_bsdf, hit_l)
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
            if with_alpha:
                wo_world, weight, is_delta, new_o = _pass_through(
                    alpha_pass, si, cur.d, wo_world, weight, is_delta, new_o)
            if with_bssrdf:
                # scatter events inside the medium: HG-redirect, keep walking
                state, u_phb = rngmod.next_float2(state)
                wo_b, w_phb, pdf_phb = phasemod.sample_phase(
                    torch.zeros(B, dtype=torch.int32, device=dev), g_b, cur.d, u_phb)
                wo_world = torch.where(bss_scatter[:, None], wo_b, wo_world)
                weight = torch.where(bss_scatter[:, None], w_phb[:, None], weight)
                next_pdf = torch.where(bss_scatter, pdf_phb, next_pdf)
                is_delta = torch.where(bss_scatter, False, is_delta)
                new_o = torch.where(bss_scatter[:, None], bss_p, new_o)
                # toggle inside/outside where a transmission lobe crosses a
                # BSSRDF surface
                trans = (s.sampled_type & _TRANSMISSION) != 0
                bss_surf = mp[si.mat_id.clamp(0, n_mat - 1).long(), 25:31].sum(-1) > 0
                toggle = hit_l & trans & bss_surf
                ins_mat = torch.where(toggle & ~ins_med, si.mat_id, ins_mat)
                ins_med = torch.where(toggle, ~ins_med, ins_med)
            w_up = up(weight)
            if C > 1:
                # a dispersive delta event makes the path monochromatic: the
                # direction is valid for the hero wavelength only. The first
                # such event zeroes the companions and scales the hero by C
                # (mono_done: a companion may legitimately be 0)
                mono = (hit_l & ((s.sampled_type & records.T_DELTA) != 0)
                        & (ctx.mat_type == schema.BSDF_DIELECTRIC)
                        & (ctx.params[:, 23] > 0.0) & ~mono_done)
                if with_media:
                    mono = mono & ~med_event
                if with_alpha:
                    mono = mono & ~alpha_pass
                hero1 = (torch.arange(C, device=dev) == 0).to(torch.float32)[None, :] * C
                w_up = torch.where(mono[:, None], w_up * hero1, w_up)
                mono_done = mono_done | mono
            beta_next = beta * w_up
            cont = hit_l | med_event | alpha_pass | bss_scatter
            alive = (cont & (weight.abs().amax(dim=-1) > 0) & (depth + 1 < max_depth))

            # --- Russian roulette on throughput ---
            state, beta_next, alive = _roulette(state, beta_next, alive,
                                                depth >= rr_depth)

            had_smooth = had_smooth | (cont & ~is_delta)
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
    if C:
        L = specmod.spectral_to_rgb(L, lam, specmod.SPECTRUM_MAX_WAVELENGTH
                                    - specmod.SPECTRUM_MIN_WAVELENGTH)
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
        self.max_depth = max_depth
        if active_types is None:
            active_types = scene_active_types(scene)
        if regularize:
            active_types = regularized_types(active_types)
        self.active_types = tuple(active_types)
        self.with_alpha = bsdfmod.scene_has_alpha(scene)
        self.with_bump = bsdfmod.scene_has_bump(scene)
        self.with_parallax = bsdfmod.scene_has_parallax(scene)
        self.with_bssrdf = bsdfmod.scene_has_bssrdf(scene)
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
            with_alpha=self.with_alpha, with_bump=self.with_bump,
            with_parallax=self.with_parallax, with_bssrdf=self.with_bssrdf,
            regularize=regularize, with_textures=self.with_textures,
            sampler_type=sampler_type, spectral=spectral)

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

    def _debug_lane(self, pixel_idx):
        rays, px, py, state, wt = tracer.gen_camera_rays(
            self.scene, pixel_idx, 0, self.pass_idx, self.width, self.height)
        L, _ = pt_radiance(self.scene, rays, state, self.max_depth,
                           active_types=self.active_types)
        return dict(L=L, ray_o=rays.o, ray_d=rays.d)


def scene_active_types(scene: schema.SceneData):
    """Static tuple of BSDF types present in the scene."""
    return tuple(sorted(set(schema.host_meta(scene)["mat_type"].tolist())))


def regularized_types(active_types):
    """active_types widened by the rough types that regularization turns
    delta lobes into."""
    return tuple(sorted(set(active_types) | set(bsdfmod.REGULARIZE_EXTRA_TYPES)))


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
