"""Vertex connection and merging.

Port of ``cudatracerlib_tpu/models/vcm.py`` (the reference's
``Integrators/VCM.cu`` with ``VCMHelper.h``): BDPT plus photons stored per
pass in a hash grid and merged at camera vertices. The light walk of
``bdpt.py`` also emits one photon row per vertex (position, power,
direction, normal, dVCM / dVC / dVM) into the sorted grid of
``ops/hashgrid.py``; each camera vertex gathers the 2x2x2 neighbourhood
once and adds the merge contributions with the full VCM MIS (eta_vcm
couples the connection and merging weights). Merging evaluates the diffuse
lobe at the camera vertex; the glossy part of transport rides the
connections.

The light and camera walks continue through one helper, ``_extend``, which
carries dVM beside BDPT's dVC and dVCM. Per pass at depth D: NUM_LIGHT_V
closest-hit light-walk traversals, NUM_LIGHT_V any-hit splats, and per
camera bounce one closest-hit, one any-hit NEE and NUM_LIGHT_V any-hit
connection traversals (BDPT's 10 + 7 * D), and D neighbourhood gathers.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import frame as fr
from ..core import records
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import hashgrid, shading, traversal, traversal8
from ..scene import schema, sensors
from . import bdpt as bdptmod
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import ppm as ppmmod
from . import tracer

Tensor = torch.Tensor
_mis = bdptmod._mis
NUM_LIGHT_V = bdptmod.NUM_LIGHT_V
# photon row: pos(3) beta(3) wi(3) ns(3) dvcm dvc dvm = 15
PHOTON_K = 15


class PassStats(NamedTuple):
    """What one pass traced and stored, on the device (no host read)."""
    rays: Tensor      # () int64 live rays traced
    photons: Tensor   # () int64 valid photon rows
    grid: hashgrid.HashGrid


def eta_vcm(radius: Tensor, n_paths: float) -> Tensor:
    """The merging density pi r^2 n_paths, in float32 as the JAX pass
    computes it."""
    return math.pi * radius * radius * n_paths


def _extend(ctx, frame, si, wi_local, dvc_h, dvcm_h, dvm_h, beta, alive, state,
            active_types, mis_vm_w, mis_vc_w):
    """Sample the BSDF at a vertex and advance the walk's VCM quantities:
    (next rays, state, beta, dvc, dvm, dvcm, active)."""
    s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, active_types)
    rev = bsdfmod.evaluate(ctx, s.wo, wi_local, active_types)
    cos_out = s.wo[..., 2].abs().clamp_min(1e-6)
    pdf_fwd = s.pdf.clamp_min(1e-12)
    is_delta_b = (s.sampled_type & records.T_DELTA) != 0
    pdf_rev = torch.where(is_delta_b, pdf_fwd, rev.pdf.clamp_min(1e-12))
    ratio = _mis(cos_out / pdf_fwd)
    dvc_n = ratio * (dvc_h * _mis(pdf_rev) + dvcm_h + mis_vm_w)
    dvm_n = ratio * (dvm_h * _mis(pdf_rev) + dvcm_h * mis_vc_w + 1.0)
    dvc = torch.where(is_delta_b, _mis(cos_out) * dvc_h, dvc_n)
    dvm = torch.where(is_delta_b, _mis(cos_out) * dvm_h, dvm_n)
    dvcm = torch.where(is_delta_b, 0.0, _mis(1.0 / pdf_fwd))
    beta = beta * s.weight
    active = alive & (s.weight.abs().amax(dim=-1) > 0)
    wo_world = frame.to_world(s.wo)
    zero = torch.zeros_like(dvc)
    rays = traversal.Rays(o=shading.offset_ray_origin(si.p, si.ng, wo_world),
                          d=wo_world, tmin=zero, tmax=zero + 1e30)
    return rays, state, beta, dvc, dvm, dvcm, active


def vcm_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
             w: int, h: int, max_depth: int, active_types, radius,
             pixel_idx: Tensor = None, total_paths: int = None,
             photon_gather_axis=None):
    """One VCM pass over all pixels; returns (film, PassStats).

    pixel_idx restricts the pass to a pixel / light-path subset (a sharded
    pass); total_paths keeps eta_vcm and the t=1 splat normalization global.
    photon_gather_axis, a ``parallel.render.Mesh`` in place of the JAX
    package's axis name, all-gathers the photon rows over the mesh before
    the grid is built: shard-major, each rank's rows in rank order, as the
    JAX pass's all_gather (not the single-device order, so a full grid cell
    may keep other photons than a single-device pass's)."""
    dev = film.rgb.device
    if pixel_idx is None:
        pixel_idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    B = pixel_idx.shape[0]
    n_paths = float(total_paths if total_paths is not None else B)
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev)
    eta = eta_vcm(radius, n_paths)
    mis_vm_w = _mis(eta)          # factor added to connection weights
    mis_vc_w = _mis(1.0 / eta)    # factor added to merging weights
    state = rngmod.seed(pixel_idx, pass_idx, 0xC3)
    geom = scene.geom
    f32 = dict(dtype=torch.float32, device=dev)
    zero = torch.zeros(B, **f32)
    types = tuple(active_types)

    # ======================= light subpath (stores photons too) ============
    er, state = lightsmod.sample_emitter_ray(scene, state)
    ltype = scene.lights.light_type[er.light_idx.long()]
    is_delta_l = ((ltype == schema.LIGHT_POINT) | (ltype == schema.LIGHT_SPOT)
                  | (ltype == schema.LIGHT_DISTANT))
    emission_pdf_w = (er.pdf_pos * er.pdf_dir).clamp_min(1e-16)
    cos_at_l = torch.where((er.n != 0).any(dim=-1),
                           vm.dot(er.n, er.d).clamp_min(1e-6), 1.0)
    # per-light-type direct pdf for the MIS partners (see bdpt.py)
    sel_l = bdptmod._sel_pdf(scene, er.light_idx)
    is_env_l = ltype == schema.LIGHT_INFINITE
    is_dist_l = ltype == schema.LIGHT_DISTANT
    direct_pdf_a = torch.where(is_env_l, er.pdf_dir * sel_l,
                               torch.where(is_dist_l, sel_l, er.pdf_pos))
    beta_l = er.power
    dvcm = _mis(direct_pdf_a / emission_pdf_w)
    dvc = torch.where(is_delta_l, 0.0, _mis(cos_at_l / emission_pdf_w))
    dvm = dvc * mis_vc_w

    rays = traversal.Rays(o=er.o + er.d * 1e-4, d=er.d, tmin=zero, tmax=zero + 1e30)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    lvs, photon_rows, photon_valid = [], [], []
    for li in range(NUM_LIGHT_V):
        trace_rays = rays._replace(tmax=torch.where(active, rays.tmax, 0.0))
        nrays = nrays + active.sum()
        hit = traversal8.intersect_scene(geom, trace_rays)
        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        alive = active & hit.valid
        dist2 = (hit.t * hit.t).clamp_min(1e-12)
        cos_in = vm.absdot(si.ns, si.wi).clamp_min(1e-6)
        if li == 0:
            # INFINITE lights: no dist^2 at the first hit (see bdpt.py)
            dist2 = torch.where(is_env_l | is_dist_l, 1.0, dist2)
        dvcm_h = dvcm * _mis(dist2) / _mis(cos_in)
        dvc_h = dvc / _mis(cos_in)
        dvm_h = dvm / _mis(cos_in)
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)
        lvs.append(bdptmod.LightVertex(
            valid=alive, p=si.p, ns=si.ns, ng=si.ng, ft=si.frame_t, fs=si.frame_s,
            wi_local=wi_local, beta=beta_l, dvcm=dvcm_h, dvc=dvc_h,
            mat_id=si.mat_id, uv=si.uv))
        photon_rows.append(torch.cat(
            [si.p, beta_l, si.wi, si.ns,
             dvcm_h[:, None], dvc_h[:, None], dvm_h[:, None]], -1))
        photon_valid.append(alive & ~bsdfmod.is_delta_only(ctx))
        rays, state, beta_l, dvc, dvm, dvcm, active = _extend(
            ctx, frame, si, wi_local, dvc_h, dvcm_h, dvm_h, beta_l, alive, state,
            types, mis_vm_w, mis_vc_w)

    rows = torch.cat(photon_rows, 0)
    valid = torch.cat(photon_valid, 0)
    del photon_rows, photon_valid
    if photon_gather_axis is not None:
        rows = photon_gather_axis.all_gather(rows)
        valid = photon_gather_axis.all_gather(valid)
    grid = hashgrid.build_grid(rows, rows[:, 0:3], valid, scene.world_lo,
                               scene.world_hi, 2.0 * radius)
    n_photons = valid.sum()
    del rows, valid

    # ---------- t=1 splats (as BDPT's, the weights gain the vm factor) ------
    for lv in lvs:
        sd = sensors.sample_direct(scene.sensor, lv.p, None)
        fr_lv = fr.Frame(lv.ft, lv.fs, lv.ns)
        wo_cam = fr_lv.to_local(sd.d)
        ctx_lv = bsdfmod.gather_ctx(scene, lv.mat_id, lv.uv, active_types=types)
        f, pdf_f, pdf_r = bdptmod._eval_with_rev(ctx_lv, lv.wi_local, wo_cam, types)
        we = sd.weight[:, 0] * (w * h)
        # cameraPdfA includes the surface cosine toward the camera (see
        # bdpt.py's t=1 splats)
        cam_pdf_a = we * wo_cam[..., 2].abs()
        w_light = _mis(cam_pdf_a / n_paths) * (mis_vm_w + lv.dvcm
                                               + lv.dvc * _mis(pdf_r))
        mis_w = 1.0 / (w_light + 1.0)
        contrib = lv.beta * f * (we / n_paths)[:, None] * mis_w[:, None]
        shadow = traversal.Rays(
            o=shading.offset_ray_origin(lv.p, lv.ng, sd.d), d=sd.d, tmin=zero,
            tmax=torch.where(lv.valid & sd.valid, sd.dist * 0.999, 0.0))
        nrays = nrays + (shadow.tmax > 0).sum()
        occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
        ok = lv.valid & sd.valid & ~occ
        px_ = sd.p_film[:, 0].to(torch.int32).clamp(0, w - 1)
        py_ = sd.p_film[:, 1].to(torch.int32).clamp(0, h - 1)
        film = filmmod.splat(film, px_, py_, contrib, mask=ok)

    # ======================= camera subpath =======================
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0,
                                                     pass_idx, w, h)
    # the perspective camera's pdf, whatever the sensor (as the JAX pass)
    params = scene.sensor.params
    tan_half = torch.tan(0.5 * params[0])
    img_dist = w / (2.0 * tan_half)
    fwd = scene.sensor.to_world[:3, 2]
    cos_cam = vm.dot(rays.d, fwd / vm.length(fwd))
    camera_pdf_w = (img_dist * img_dist) / (cos_cam ** 3).clamp_min(1e-6)
    beta_c = torch.ones((B, 3), **f32)
    dvcm_c = _mis(n_paths / camera_pdf_w.clamp_min(1e-12))
    dvc_c = zero
    dvm_c = zero
    active_c = torch.ones(B, dtype=torch.bool, device=dev)
    L = torch.zeros((B, 3), **f32)
    has_env = lightsmod.has_env_static(scene.lights)
    if has_env:
        _, env_row = lightsmod._env_row(scene.lights)
        wr = scene.lights.params.index_select(0, env_row)[0, 7].clamp_min(1e-3)
    r_lane = radius.expand(B)

    for t_idx in range(max_depth):
        trace_rays = rays._replace(tmax=torch.where(active_c, rays.tmax, 0.0))
        nrays = nrays + active_c.sum()
        hit = traversal8.intersect_scene(geom, trace_rays)
        si = shading.fill_dg(geom, trace_rays, hit, flip_to_ray=False)
        alive = active_c & hit.valid
        dist2 = (hit.t * hit.t).clamp_min(1e-12)
        cos_in = vm.absdot(si.ns, si.wi).clamp_min(1e-6)
        dvcm_h = dvcm_c * _mis(dist2) / _mis(cos_in)
        dvc_h = dvc_c / _mis(cos_in)
        dvm_h = dvm_c / _mis(cos_in)

        # s=0: emitter hit
        le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
        lid = si.light_id.clamp(0, scene.lights.params.shape[0] - 1)
        sel = bdptmod._sel_pdf(scene, lid)
        area = scene.lights.params[lid.long()][:, 6].clamp_min(1e-12)
        cos_l0 = vm.dot(si.ng, si.wi).clamp_min(1e-6)
        w_cam0 = (_mis(sel / area) * dvcm_h
                  + _mis(sel / area * cos_l0 / math.pi) * dvc_h)
        mis_w0 = torch.ones_like(w_cam0) if t_idx == 0 else 1.0 / (1.0 + w_cam0)
        L = L + torch.where(alive[:, None], beta_c * le * mis_w0[:, None], 0.0)

        # s=0 at infinity: escaped rays hit the env light (see bdpt.py)
        if has_env:
            env_le = lightsmod.eval_environment(scene, rays.d)
            pdf_env_d = lightsmod.pdf_env_direct(scene, rays.d)
            w_cam_env = (_mis(pdf_env_d) * dvcm_c
                         + _mis(pdf_env_d / (math.pi * wr * wr)) * dvc_c)
            mis_env = (torch.ones_like(w_cam_env) if t_idx == 0
                       else 1.0 / (1.0 + w_cam_env))
            env_mask = active_c & ~hit.valid
            L = L + torch.where(env_mask[:, None],
                                beta_c * env_le * mis_env[:, None], 0.0)

        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)

        # s=1: direct illumination
        ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
        direct_w, emission_w, cos_at_light = bdptmod._emission_pdfs(scene, ed)
        wo_l = frame.to_local(ed.d)
        f1, pdf_f1, pdf_r1 = bdptmod._eval_with_rev(ctx, wi_local, wo_l, types)
        cos_to_l = vm.absdot(si.ns, ed.d).clamp_min(1e-6)
        w_light1 = torch.where(ed.is_delta, 0.0, _mis(pdf_f1 / direct_w))
        w_cam1 = (_mis(emission_w * cos_to_l / (direct_w * cos_at_light))
                  * (mis_vm_w + dvcm_h + dvc_h * _mis(pdf_r1)))
        mis_w1 = 1.0 / (w_light1 + 1.0 + w_cam1)
        shadow = traversal.Rays(
            o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d, tmin=zero,
            tmax=torch.where(alive & (pdf_f1 + vm.length_sqr(f1) > 0),
                             ed.dist * 0.999, 0.0))
        nrays = nrays + (shadow.tmax > 0).sum()
        occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
        L = L + torch.where((alive & ~occ)[:, None],
                            beta_c * f1 * ed.radiance_over_pdf * mis_w1[:, None], 0.0)

        # s>=2: vertex connections (the weights gain the vm factors)
        for lv in lvs:
            dvec = lv.p - si.p
            d2 = vm.length_sqr(dvec).clamp_min(1e-12)
            dist = torch.sqrt(d2)
            dirn = dvec / dist[:, None]
            wo_c = frame.to_local(dirn)
            f_c, pdf_cf, pdf_cr = bdptmod._eval_with_rev(ctx, wi_local, wo_c, types)
            fr_lv = fr.Frame(lv.ft, lv.fs, lv.ns)
            wo_lv = fr_lv.to_local(-dirn)
            ctx_lv = bsdfmod.gather_ctx(scene, lv.mat_id, lv.uv, active_types=types)
            f_l, pdf_lf, pdf_lr = bdptmod._eval_with_rev(ctx_lv, lv.wi_local,
                                                         wo_lv, types)
            cos_c = vm.absdot(si.ns, dirn).clamp_min(1e-6)
            cos_lv = vm.absdot(lv.ns, dirn).clamp_min(1e-6)
            pdf_cf_a = pdf_cf * cos_lv / d2
            pdf_lf_a = pdf_lf * cos_c / d2
            w_light = _mis(pdf_cf_a) * (mis_vm_w + lv.dvcm + lv.dvc * _mis(pdf_lr))
            w_cam = _mis(pdf_lf_a) * (mis_vm_w + dvcm_h + dvc_h * _mis(pdf_cr))
            mis_w = 1.0 / (w_light + 1.0 + w_cam)
            contrib = (beta_c * f_c) * (lv.beta * f_l) * (mis_w / d2)[:, None]
            ok = alive & lv.valid & (contrib.amax(dim=-1) > 0)
            shadow = traversal.Rays(
                o=shading.offset_ray_origin(si.p, si.ng, dirn), d=dirn, tmin=zero,
                tmax=torch.where(ok, dist * 0.998, 0.0))
            nrays = nrays + ok.sum()
            occ = traversal8.intersect_scene(geom, shadow, any_hit=True).valid
            L = L + torch.where((ok & ~occ)[:, None], contrib, 0.0)

        # ---------- merging (VM): gather photons at this camera vertex ------
        merge_here = alive & ~bsdfmod.is_delta_only(ctx)
        albedo = ppmmod.diffuse_albedo(ctx)

        def accum(carry, prows, mask):
            # vectorised over the whole (B, 128, 15) neighbourhood
            ph_beta = prows[..., 3:6]
            ph_wi = prows[..., 6:9]
            ph_ns = prows[..., 9:12]
            ph_dvcm = prows[..., 12]
            ph_dvm = prows[..., 14]
            ns_ = si.ns[:, None, :]
            cos_wi = (ph_wi * ns_).sum(-1)
            ok = mask & ((ph_ns * ns_).sum(-1) > 0.5) & (cos_wi > 0)
            # diffuse merge: f = albedo/pi, pdfs = cos/pi both ways
            pdf_fwd = cos_wi.abs().clamp_min(1e-6) / math.pi
            pdf_rev = cos_in / math.pi
            w_light = ph_dvcm * mis_vc_w + ph_dvm * _mis(pdf_fwd)
            w_cam = dvcm_h * mis_vc_w + dvm_h * _mis(pdf_rev)
            mis_w = 1.0 / (w_light + 1.0 + w_cam[:, None])
            f = (albedo / math.pi)[:, None, :]
            contrib = f * ph_beta * mis_w[..., None]
            return carry + torch.where(ok[..., None], contrib, 0.0).sum(dim=1)

        flux = hashgrid.gather_neighbors(grid, si.p, r_lane, accum,
                                         torch.zeros((B, 3), **f32))
        Lm = beta_c * flux / eta   # 1/(pi r^2 n_paths): all lanes' photons
        L = L + torch.where(merge_here[:, None], Lm, 0.0)

        # extend the camera path
        rays, state, beta_c, dvc_c, dvm_c, dvcm_c, active_c = _extend(
            ctx, frame, si, wi_local, dvc_h, dvcm_h, dvm_h, beta_c, alive, state,
            types, mis_vm_w, mis_vc_w)

    film = filmmod.add_samples(film, px, py, L * wt)
    return film, PassStats(rays=nrays, photons=n_photons, grid=grid)


class VCM(tracer.TracerBase):
    """Vertex connection and merging (reference VCM) with a progressive
    per-pass merge radius r_i = r_0 * i^((alpha - 1) / 2).

    Besides ``status()``: ``rays_traced_live``, ``photons_stored`` (valid
    photon rows over all passes), ``radius`` (the last pass's) and
    ``last_grid`` (the last pass's photon grid, on the device)."""

    def __init__(self, scene, width, height, max_depth: int = 6,
                 initial_radius: Optional[float] = None, alpha: float = 0.75,
                 seed: int = 0, active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, seed=seed)
        from . import path as pathmod
        self.max_depth = max_depth
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        if initial_radius is None:
            meta = schema.host_meta(scene)
            diag = float(np.linalg.norm(meta["world_hi"] - meta["world_lo"]))
            initial_radius = diag * 0.005
        self.initial_radius = float(initial_radius)
        self.alpha = alpha
        self.radius = self.initial_radius
        dev = scene.device
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._stored_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self.last_grid = None

    def render_pass(self, scene, film, pass_idx):
        # the radius schedule r_i = r_0 * i^((alpha-1)/2)
        i = max(self.pass_idx + 1, 1)
        self.radius = self.initial_radius * (i ** ((self.alpha - 1.0) / 2.0))
        film, st = vcm_pass(scene, film, pass_idx, self.width, self.height,
                            self.max_depth, self.active_types, radius=self.radius)
        self._rays_dev = self._rays_dev + st.rays
        self._stored_dev = self._stored_dev + st.photons
        self.last_grid = st.grid
        return film

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)

    @property
    def photons_stored(self) -> int:
        """Valid photon rows over all passes."""
        return int(self._stored_dev)
