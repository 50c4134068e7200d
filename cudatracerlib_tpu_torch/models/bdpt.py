"""Bidirectional path tracer.

Port of ``cudatracerlib_tpu/models/bdpt.py`` (the reference's
``Integrators/BDPT.cu`` with ``VCMHelper.h``): a light subpath of up to
NUM_LIGHT_V = 5 vertices per pixel, a camera walk that connects to every
stored vertex, samples the emitters and splats light vertices to the camera,
with the recursive VCM-style dVC / dVCM MIS quantities (balance heuristic)
over the s=0 (hit), s=1 (direct sampling), s>=2 (vertex connection) and t=1
(camera splat) families.

The JAX package's three ``lax.scan``s (the light walk, the t=1 splats, the
camera walk with its inner scan over the stored vertices) are Python loops
here; the light vertices are NUM_LIGHT_V ``LightVertex`` tuples of tensors.
All W*H lanes run at once. Every traversal is one wavefront of W*H rays:
per pass NUM_LIGHT_V closest-hit light-walk rays, NUM_LIGHT_V any-hit
splats, and per camera bounce one closest-hit ray, one any-hit NEE ray and
NUM_LIGHT_V any-hit connections, 10 + 7 * max_depth traversals in all.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

from ..core import frame as fr
from ..core import records
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema, sensors
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import tracer

Tensor = torch.Tensor
NUM_LIGHT_V = 5


def _mis(x):
    return x  # balance heuristic (exponent 1), like the reference's default


class LightVertex(NamedTuple):
    valid: Tensor     # (B,)
    p: Tensor         # (B,3)
    ns: Tensor        # (B,3)
    ng: Tensor        # (B,3)
    ft: Tensor        # (B,3) frame tangent
    fs: Tensor        # (B,3) frame bitangent
    wi_local: Tensor  # (B,3) incoming dir (toward previous vertex), local
    beta: Tensor      # (B,3) accumulated throughput
    dvcm: Tensor      # (B,)
    dvc: Tensor       # (B,)
    mat_id: Tensor    # (B,)
    uv: Tensor        # (B,2)


def _sel_pdf(scene, light_idx):
    """The power-CDF selection probability of each lane's light."""
    cdf = scene.lights.power_cdf
    lid = light_idx.long()
    prev = torch.where(light_idx > 0, cdf[(lid - 1).clamp_min(0)], 0.0)
    return (cdf[lid] - prev).clamp_min(1e-12)


def _emission_pdfs(scene, ed: lightsmod.EmitterDirect):
    """(direct_pdf_w, emission_pdf_w, cos_at_light) for a sampled NEE record."""
    lid = ed.light_idx.long()
    ltype = scene.lights.light_type[lid]
    sel = _sel_pdf(scene, ed.light_idx)
    p = scene.lights.params[lid]
    # env records carry n=0 (no surface at infinity): cosAtLight is 1 by the
    # background-light convention, not the 1e-6 clamp
    no_surface = ed.is_delta | (ltype == schema.LIGHT_INFINITE)
    cos_l = torch.where(no_surface, 1.0, vm.dot(ed.n, -ed.d).clamp_min(1e-6))
    area = p[:, 6].clamp_min(1e-12)
    # area light: emission pdf = (sel/A) * cos/pi
    emission_area = sel / area * cos_l / math.pi
    # delta lights: emission pdf = sel * dir-pdf
    emission_pt = sel * (1.0 / (4.0 * math.pi))
    cutoff = p[:, 6]
    emission_spot = sel / (2.0 * math.pi * (1.0 - cutoff)).clamp_min(1e-6)
    world_r = p[:, 7].clamp_min(1e-3)
    emission_dist = sel / (math.pi * world_r * world_r)
    emission = torch.where(
        ltype == schema.LIGHT_DIFFUSE, emission_area,
        torch.where(ltype == schema.LIGHT_POINT, emission_pt,
        torch.where(ltype == schema.LIGHT_SPOT, emission_spot,
        torch.where(ltype == schema.LIGHT_DISTANT, emission_dist,
                    ed.pdf.clamp_min(1e-12) / (math.pi * world_r * world_r)))))
    # the "direct pdf" the MIS ratios divide by (SmallVCM Illuminate
    # conventions): position-delta lights (point/spot) fold dist^2 so the
    # emission/direct ratio lands in the light-trace area measure at the
    # receiver; the direction-delta distant light stays at the pick prob
    is_dist = ltype == schema.LIGHT_DISTANT
    direct_w = torch.where(ed.is_delta,
                           torch.where(is_dist, sel, sel * ed.dist * ed.dist),
                           ed.pdf.clamp_min(1e-12))
    return direct_w, emission, cos_l


def _eval_with_rev(ctx, wi_local, wo_local, active_types):
    lob = bsdfmod.evaluate(ctx, wi_local, wo_local, active_types)
    rev = bsdfmod.evaluate(ctx, wo_local, wi_local, active_types)
    return lob.f, lob.pdf, rev.pdf


def _extend(ctx, frame, si, wi_local, dvc_h, dvcm_h, beta, alive, state,
            active_types):
    """Sample the BSDF at a vertex and advance the walk's MIS quantities:
    (next rays, state, beta, dvc, dvcm, active)."""
    s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types)
    rev = bsdfmod.evaluate(ctx, s.wo, wi_local, active_types)
    cos_out = s.wo[..., 2].abs().clamp_min(1e-6)
    pdf_fwd = s.pdf.clamp_min(1e-12)
    is_delta_b = (s.sampled_type & records.T_DELTA) != 0
    pdf_rev = torch.where(is_delta_b, pdf_fwd, rev.pdf.clamp_min(1e-12))
    dvc = _mis(cos_out / pdf_fwd) * (dvc_h * _mis(pdf_rev) + dvcm_h)
    dvc = torch.where(is_delta_b, _mis(cos_out / pdf_fwd) * dvc_h * _mis(pdf_rev), dvc)
    dvcm = torch.where(is_delta_b, 0.0, _mis(1.0 / pdf_fwd))
    beta = beta * s.weight
    active = alive & (s.weight.abs().amax(dim=-1) > 0)
    wo_world = frame.to_world(s.wo)
    zero = torch.zeros_like(dvc)
    rays = traversal.Rays(o=shading.offset_ray_origin(si.p, si.ng, wo_world),
                          d=wo_world, tmin=zero, tmax=zero + 1e30)
    return rays, state, beta, dvc, dvcm, active


def bdpt_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
              w: int, h: int, max_depth: int, active_types,
              force_s: int = -1, force_t: int = -1,
              pixel_idx: Tensor = None, total_paths: int = None):
    """One BDPT pass over all pixels; returns (film, live rays traced as an
    int64 tensor). force_s / force_t isolate a single connection family
    (reference BDPT Force_s / Force_t debug knobs): they mask contributions
    and never skip code, so every family consumes the same RNG stream and
    the per-family renders sum exactly to the full render.

    pixel_idx restricts the pass to a pixel / light-path subset (a sharded
    pass); total_paths keeps the t=1 splat normalization global."""
    dev = film.rgb.device
    if pixel_idx is None:
        pixel_idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    B = pixel_idx.shape[0]
    n_paths = float(total_paths if total_paths is not None else B)
    state = rngmod.seed(pixel_idx, pass_idx, 0xB0)
    geom = scene.geom
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(B, **f32)
    types = tuple(active_types)

    def use(s_fam, t_fam):
        """Whether the strategy (s_fam, t_fam) contributes: a Python bool
        that masks its contribution (the code runs either way)."""
        return ((force_s < 0 or s_fam == force_s)
                and (force_t < 0 or t_fam == force_t))

    # ======================= light subpath =======================
    er, state = lightsmod.sample_emitter_ray(scene, state)
    ltype = scene.lights.light_type[er.light_idx.long()]
    is_delta_l = ((ltype == schema.LIGHT_POINT) | (ltype == schema.LIGHT_SPOT)
                  | (ltype == schema.LIGHT_DISTANT))
    emission_pdf_w = (er.pdf_pos * er.pdf_dir).clamp_min(1e-16)
    cos_at_l = torch.where((er.n != 0).any(dim=-1),
                           vm.dot(er.n, er.d).clamp_min(1e-6), 1.0)
    # direct pdf (for the NEE-partner weights): area measure for surface
    # lights; for INFINITE lights the roles swap (SmallVCM background
    # convention: the partner samples the DIRECTION, so use the solid-angle
    # pdf x pick); DISTANT lights are direction-deltas whose NEE partner
    # density is just the pick prob
    sel_l = _sel_pdf(scene, er.light_idx)
    is_env_l = ltype == schema.LIGHT_INFINITE
    is_dist_l = ltype == schema.LIGHT_DISTANT
    direct_pdf_a = torch.where(is_env_l, er.pdf_dir * sel_l,
                               torch.where(is_dist_l, sel_l, er.pdf_pos))
    beta_l = er.power / n_paths * (w * h)  # = er.power for n_paths == w*h
    dvcm = _mis(direct_pdf_a / emission_pdf_w)
    dvc = torch.where(is_delta_l, 0.0, _mis(cos_at_l / emission_pdf_w))
    rays = traversal.Rays(o=er.o + er.d * 1e-4, d=er.d, tmin=zero, tmax=zero + 1e30)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    # INFINITE lights (distant/env) emit parallel beams from the far disk:
    # the solid-angle -> area dist^2 factor does not apply at their FIRST hit
    # (SmallVCM mIsFiniteLight convention)
    skip_d2 = is_env_l | is_dist_l

    lvs = []
    for li in range(NUM_LIGHT_V):
        trace_rays = rays._replace(tmax=torch.where(active, rays.tmax, 0.0))
        nrays = nrays + active.sum()
        hit = traversal8.intersect_scene(geom, trace_rays)
        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        alive = active & hit.valid
        dist2 = (hit.t * hit.t).clamp_min(1e-12)
        cos_in = vm.absdot(si.ns, si.wi).clamp_min(1e-6)
        d2 = torch.where(skip_d2, 1.0, _mis(dist2)) if li == 0 else _mis(dist2)
        dvcm_h = dvcm * d2 / _mis(cos_in)
        dvc_h = dvc / _mis(cos_in)
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)
        lvs.append(LightVertex(
            valid=alive, p=si.p, ns=si.ns, ng=si.ng, ft=si.frame_t, fs=si.frame_s,
            wi_local=wi_local, beta=beta_l, dvcm=dvcm_h, dvc=dvc_h,
            mat_id=si.mat_id, uv=si.uv))
        # continue the light walk
        rays, state, beta_l, dvc, dvcm, active = _extend(
            ctx, frame, si, wi_local, dvc_h, dvcm_h, beta_l, alive, state, types)

    # ---------- t=1: splat every light vertex to the camera ----------
    for lv, s_fam in zip(lvs, range(2, NUM_LIGHT_V + 2)):
        sd = sensors.sample_direct(scene.sensor, lv.p, None)
        fr_lv = fr.Frame(lv.ft, lv.fs, lv.ns)
        wo_cam = fr_lv.to_local(sd.d)
        ctx_lv = bsdfmod.gather_ctx(scene, lv.mat_id, lv.uv, active_types=types)
        f, pdf_f, pdf_r = _eval_with_rev(ctx_lv, lv.wi_local, wo_cam, types)
        we = sd.weight[:, 0] * (w * h)  # pixel-units importance We/dist^2
        # MIS partner density: the t>=2 strategies sample this vertex with
        # cameraPdfA = We/dist^2 * |cos at the SURFACE toward the camera|
        # (SmallVCM imageToSurfaceFactor)
        cam_pdf_a = we * wo_cam[..., 2].abs()
        w_light = _mis(cam_pdf_a / n_paths) * (lv.dvcm + lv.dvc * _mis(pdf_r))
        mis_w = 1.0 / (w_light + 1.0)
        contrib = lv.beta * f * (we / n_paths)[:, None] * mis_w[:, None]
        shadow = traversal.Rays(
            o=shading.offset_ray_origin(lv.p, lv.ng, sd.d), d=sd.d, tmin=zero,
            tmax=torch.where(lv.valid & sd.valid, sd.dist * 0.999, 0.0))
        nrays = nrays + (shadow.tmax > 0).sum()
        occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
        ok = lv.valid & sd.valid & ~occ & use(s_fam, 1)
        # clipped: every index stays inside the film
        px = sd.p_film[:, 0].to(torch.int32).clamp(0, w - 1)
        py = sd.p_film[:, 1].to(torch.int32).clamp(0, h - 1)
        film = filmmod.splat(film, px, py, contrib, mask=ok)

    # ======================= camera subpath =======================
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0,
                                                     pass_idx, w, h)
    params = scene.sensor.params
    tan_half = torch.tan(0.5 * params[0])
    img_dist = w / (2.0 * tan_half)  # image plane distance in pixel units
    fwd = scene.sensor.to_world[:3, 2]
    cos_cam = vm.dot(rays.d, fwd / vm.length(fwd))
    camera_pdf_w = (img_dist * img_dist) / (cos_cam ** 3).clamp_min(1e-6)
    dvcm_c = _mis(n_paths / camera_pdf_w.clamp_min(1e-12))
    dvc_c = zero
    beta_c = torch.ones((B, 3), **f32)
    active_c = torch.ones(B, dtype=torch.bool, device=dev)
    L = torch.zeros((B, 3), **f32)
    has_env = lightsmod.has_env_static(scene.lights)
    if has_env:
        _, env_row = lightsmod._env_row(scene.lights)
        wr = scene.lights.params.index_select(0, env_row)[0, 7].clamp_min(1e-3)

    for t_idx in range(max_depth):
        t_fam = t_idx + 2  # camera sub-path length incl. the camera vertex
        trace_rays = rays._replace(tmax=torch.where(active_c, rays.tmax, 0.0))
        nrays = nrays + active_c.sum()
        hit = traversal8.intersect_scene(geom, trace_rays)
        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        alive = active_c & hit.valid
        dist2 = (hit.t * hit.t).clamp_min(1e-12)
        cos_in = vm.absdot(si.ns, si.wi).clamp_min(1e-6)
        dvcm_h = dvcm_c * _mis(dist2) / _mis(cos_in)
        dvc_h = dvc_c / _mis(cos_in)

        # ---------- s=0: the camera path hits an emitter ----------
        le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
        lid = si.light_id.clamp(0, scene.lights.params.shape[0] - 1)
        sel = _sel_pdf(scene, lid)
        lp = scene.lights.params[lid.long()]
        area = lp[:, 6].clamp_min(1e-12)
        cos_l = vm.dot(si.ng, si.wi).clamp_min(1e-6)
        direct_pdf_a = sel / area
        emission_pdf_w = sel / area * cos_l / math.pi
        w_cam = _mis(direct_pdf_a) * dvcm_h + _mis(emission_pdf_w) * dvc_h
        mis_w = torch.ones_like(w_cam) if t_idx == 0 else 1.0 / (1.0 + w_cam)
        hit_mask = alive & use(0, t_fam)
        L = L + torch.where(hit_mask[:, None], beta_c * le * mis_w[:, None], 0.0)

        # ---------- s=0 at infinity: escaped rays hit the env light ----------
        if has_env:
            env_le = lightsmod.eval_environment(scene, rays.d)
            pdf_env_d = lightsmod.pdf_env_direct(scene, rays.d)  # dir pdf * sel
            # SmallVCM background convention: no dist^2/cos surface
            # conversion, raw dVCM/dVC with (dir pdf, dir * disk-pos pdf)
            w_cam_env = (_mis(pdf_env_d) * dvcm_c
                         + _mis(pdf_env_d / (math.pi * wr * wr)) * dvc_c)
            mis_env = (torch.ones_like(w_cam_env) if t_idx == 0
                       else 1.0 / (1.0 + w_cam_env))
            env_mask = active_c & ~hit.valid & use(0, t_fam)
            L = L + torch.where(env_mask[:, None],
                                beta_c * env_le * mis_env[:, None], 0.0)

        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)

        # ---------- s=1: direct illumination sampling ----------
        ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
        direct_w, emission_w, cos_at_light = _emission_pdfs(scene, ed)
        wo_l = frame.to_local(ed.d)
        f, pdf_f, pdf_r = _eval_with_rev(ctx, wi_local, wo_l, types)
        cos_to_l = vm.absdot(si.ns, ed.d).clamp_min(1e-6)
        w_light = torch.where(ed.is_delta, 0.0, _mis(pdf_f / direct_w))
        w_cam = (_mis(emission_w * cos_to_l / (direct_w * cos_at_light))
                 * (dvcm_h + dvc_h * _mis(pdf_r)))
        mis_w = 1.0 / (w_light + 1.0 + w_cam)
        shadow = traversal.Rays(
            o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d, tmin=zero,
            tmax=torch.where(alive & (pdf_f + vm.length_sqr(f) > 0),
                             ed.dist * 0.999, 0.0))
        nrays = nrays + (shadow.tmax > 0).sum()
        occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
        contrib = beta_c * f * ed.radiance_over_pdf * mis_w[:, None]
        nee_mask = alive & ~occ & use(1, t_fam)
        L = L + torch.where(nee_mask[:, None], contrib, 0.0)

        # ---------- s>=2: connect to the stored light vertices ----------
        for lv, s_fam in zip(lvs, range(2, NUM_LIGHT_V + 2)):
            dvec = lv.p - si.p
            d2 = vm.length_sqr(dvec).clamp_min(1e-12)
            dist = torch.sqrt(d2)
            dirn = dvec / dist[:, None]
            # camera-side BSDF toward the light vertex
            wo_c = frame.to_local(dirn)
            f_c, pdf_cf, pdf_cr = _eval_with_rev(ctx, wi_local, wo_c, types)
            # light-side BSDF toward the camera vertex
            fr_lv = fr.Frame(lv.ft, lv.fs, lv.ns)
            wo_lv = fr_lv.to_local(-dirn)
            ctx_lv = bsdfmod.gather_ctx(scene, lv.mat_id, lv.uv, active_types=types)
            f_l, pdf_lf, pdf_lr = _eval_with_rev(ctx_lv, lv.wi_local, wo_lv, types)
            cos_c = vm.absdot(si.ns, dirn).clamp_min(1e-6)
            cos_lv = vm.absdot(lv.ns, dirn).clamp_min(1e-6)
            # evaluate() returns f*cos: divide out the cosines, use G explicitly
            geom_term = 1.0 / d2
            pdf_cf_a = pdf_cf * cos_lv / d2
            pdf_lf_a = pdf_lf * cos_c / d2
            w_light = _mis(pdf_cf_a) * (lv.dvcm + lv.dvc * _mis(pdf_lr))
            w_cam = _mis(pdf_lf_a) * (dvcm_h + dvc_h * _mis(pdf_cr))
            mis_w = 1.0 / (w_light + 1.0 + w_cam)
            contrib = (beta_c * f_c) * (lv.beta * f_l) * (geom_term * mis_w)[:, None]
            ok = alive & lv.valid & (contrib.amax(dim=-1) > 0)
            shadow = traversal.Rays(
                o=shading.offset_ray_origin(si.p, si.ng, dirn), d=dirn, tmin=zero,
                tmax=torch.where(ok, dist * 0.998, 0.0))
            nrays = nrays + ok.sum()
            occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
            conn_mask = ok & ~occ & use(s_fam, t_fam)
            L = L + torch.where(conn_mask[:, None], contrib, 0.0)

        # ---------- extend the camera path ----------
        rays, state, beta_c, dvc_c, dvcm_c, active_c = _extend(
            ctx, frame, si, wi_local, dvc_h, dvcm_h, beta_c, alive, state, types)

    film = filmmod.add_samples(film, px, py, L * wt)
    return film, nrays


class BDPT(tracer.TracerBase):
    """Bidirectional path tracer (reference BDPT) with the Force_s / Force_t
    knobs. The live-ray count is an int64 tensor, ``_rays_dev``."""

    def __init__(self, scene, width, height, max_depth: int = 6,
                 force_s: int = -1, force_t: int = -1, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, seed=seed)
        from . import path as pathmod
        self.max_depth = max_depth
        self.force_s, self.force_t = force_s, force_t
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=scene.device)

    def render_pass(self, scene, film, pass_idx):
        film, nrays = bdpt_pass(scene, film, pass_idx, self.width, self.height,
                                self.max_depth, self.active_types,
                                force_s=self.force_s, force_t=self.force_t)
        self._rays_dev = self._rays_dev + nrays
        return film

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)
