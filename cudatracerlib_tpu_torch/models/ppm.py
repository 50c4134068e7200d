"""Progressive photon mapping (surface and volumetric estimators).

Port of ``cudatracerlib_tpu/models/ppm.py`` (the reference's
``Integrators/ProgressivePhotonMapping/PPPMTracer*``): a photon pass walks
all W*H light paths at once, bounce by bounce, and stores photons at
surface hits with a smooth component and, in media, at delta-tracked
medium events; the photons are sorted into hash grids (ops/hashgrid.py).
The eye pass walks camera paths through specular chains to their first
smooth vertex and gathers there over the 2x2x2 cell neighborhood, with the
progressively shrinking radius (alpha = 2/3, ``PhotonMapHelper.h:16-21``)
or per-pixel adaptive radii; along each camera segment in a medium one of
three volumetric estimators adds the in-scattered light: "beamgrid" (the
default), "beambeam" (models/vol_estimators.py) or "point"
(``volumetric_radiance``).

The JAX tracer fuses the ball grid's build into its beamgrid eye program
(an XLA device); eager PyTorch runs the same calls either way, so there is
one beamgrid route.

Counters: the live rays each pass traces (int64, on the device, as the
light tracer keeps them), the photons stored per pass (surface, medium),
the exit tests of the tracking and DDA loops read back from the device per
pass, and the DDA steps per eye-pass depth.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core import kernels as kernelsmod
from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import dda, hashgrid, shading, traversal, traversal8
from ..scene import schema
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import medium as mediummod
from . import phase as phasemod
from . import tracer
from . import vol_estimators as ve

Tensor = torch.Tensor

# photon row: [pos(3), power(3), wi(3), normal(3)] = 12 floats
PHOTON_K = 12
INV_PI = 1.0 / math.pi


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def trace_photons(scene: schema.SceneData, n_photons: int, pass_idx, state_seed,
                  max_depth: int, active_types, store_medium: bool = False,
                  collect_beams: bool = False, photon_ids: Tensor = None,
                  total_photons: int = None):
    """Light walk storing photons at diffuse-ish surface hits (and medium
    events when store_medium). Returns (rows (N*D, 12), valid), plus
    (beams (N*D, 16), beams_valid) when collect_beams: one photon beam per
    traversed medium segment (reference Beam.h photon-beam storage), rows
    [o(3) d(3) t_len(1) power(3) sigma_t(3) pad(3)] with power = throughput
    at the segment origin."""
    return _photon_walk(scene, n_photons, pass_idx, state_seed, max_depth,
                        active_types, store_medium, collect_beams, photon_ids,
                        total_photons)[0]


def _photon_walk(scene, n_photons, pass_idx, state_seed, max_depth,
                 active_types, store_medium=False, collect_beams=False,
                 photon_ids=None, total_photons=None):
    """trace_photons' walk; returns (its outputs, the int64 count of walk
    rays traced with tmax > 0)."""
    dev = scene.device
    B = n_photons
    if photon_ids is None:
        photon_ids = torch.arange(B, dtype=torch.int32, device=dev)
    types = tuple(active_types)
    f32 = dict(dtype=torch.float32, device=dev)
    state = rngmod.seed(photon_ids, pass_idx, state_seed)
    er, state = lightsmod.sample_emitter_ray(scene, state)
    beta = er.power / float(total_photons or B)
    zero = torch.zeros(B, **f32)
    rays = traversal.Rays(o=er.o + er.d * 1e-4, d=er.d, tmin=zero, tmax=zero + 1e30)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    with_media = store_medium and mediummod.has_media(scene.media)
    if collect_beams and with_media:
        lo_m, hi_m = mediummod.media_aabb(scene.media)
    rows_out, valid_out = [], []
    beams_out, beams_valid_out = [], []
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    pad3 = torch.zeros((B, 3), **f32)

    for depth in range(max_depth):
        trace_rays = rays._replace(tmax=torch.where(active, rays.tmax, 0.0))
        nrays = nrays + active.sum()
        hit = traversal8.intersect_scene(scene.geom, trace_rays)

        if with_media:
            t_seg = torch.where(hit.valid, hit.t * 0.999, 1e7)
            beta_seg = beta
            ms, state = mediummod.sample_distance(scene.media, rays.o, rays.d,
                                                  t_seg, state, active)
            beta = beta * ms.weight
            med_event = ms.valid
            rows_out.append(torch.cat([ms.p, beta, -rays.d, pad3], -1))
            valid_out.append(med_event)
            if collect_beams:
                # clip the beam to the media AABB: only the in-medium part
                # scatters, and a bounded length keeps the rasterization
                # (build_beam_cells) dense enough to cover every cell
                inv = 1.0 / torch.where(rays.d.abs() < 1e-12, 1e-12, rays.d)
                ta = (lo_m - rays.o) * inv
                tb = (hi_m - rays.o) * inv
                t_in = torch.minimum(ta, tb).amax(-1).clamp_min(0.0)
                t_out = torch.maximum(ta, tb).amin(-1)
                t_end = torch.where(med_event, ms.t,
                                    torch.where(hit.valid, hit.t, t_out))
                t_end = torch.minimum(t_end, t_out)
                b_len = (t_end - t_in).clamp_min(0.0)
                b_o = rays.o + rays.d * t_in[:, None]
                sa0, ss0, _, _ = mediummod.sigma_at(scene.media, b_o + rays.d * 1e-4)
                beams_out.append(torch.cat([b_o, rays.d, b_len[:, None], beta_seg,
                                            sa0 + ss0, pad3], -1))
                beams_valid_out.append(active & (b_len > 0))
        else:
            med_event = torch.zeros(B, dtype=torch.bool, device=dev)

        si = shading.fill_dg(scene.geom, trace_rays, hit, flip_to_ray=False)
        alive = active & hit.valid & ~med_event
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        # store photons only on surfaces with a smooth (non-delta) component
        storable = alive & ~bsdfmod.is_delta_only(ctx)
        rows_out.append(torch.cat([si.p, beta, si.wi, si.ns], -1))
        valid_out.append(storable)

        frame = si.frame()
        wi_local = frame.to_local(si.wi)
        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, types)
        wo_world = frame.to_world(s.wo)
        beta2 = beta * s.weight
        cont = alive & (s.weight.abs().amax(-1) > 0)
        if with_media:
            state, u_ph = rngmod.next_float2(state)
            wo_ph, w_ph, _ = phasemod.sample_phase(ms.ptype, ms.g, rays.d, u_ph)
            wo_world = torch.where(med_event[:, None], wo_ph, wo_world)
            beta2 = torch.where(med_event[:, None], beta * w_ph[:, None], beta2)
            cont = cont | med_event
        state, u_rr = rngmod.next_float(state)
        q = beta2.amax(-1).clamp(0.05, 0.95)
        if depth >= 2:
            survive = u_rr < q
            beta = torch.where(survive[:, None], beta2 / q.clamp_min(1e-6)[:, None],
                               beta2)
        else:
            survive = torch.ones(B, dtype=torch.bool, device=dev)
            beta = beta2
        active = cont & survive
        new_o = shading.offset_ray_origin(si.p, si.ng, wo_world)
        if with_media:
            new_o = torch.where(med_event[:, None], ms.p, new_o)
        rays = traversal.Rays(o=new_o, d=wo_world, tmin=zero, tmax=zero + 1e30)

    out = (torch.cat(rows_out, 0), torch.cat(valid_out, 0))
    if collect_beams:
        out = out + (torch.cat(beams_out, 0), torch.cat(beams_valid_out, 0))
    return out, nrays


def diffuse_albedo(ctx: bsdfmod.BsdfCtx) -> Tensor:
    """Diffuse reflectance used for the gather-time BRDF approximation
    (photon gathering at non-delta vertices; the glossy part of the
    transport is carried by the eye walk and the photon directions)."""
    t = ctx.mat_type
    # plastics/phong/ward keep their diffuse color in c1
    use_c1 = ((t == schema.BSDF_PLASTIC) | (t == schema.BSDF_ROUGHPLASTIC)
              | (t == schema.BSDF_PHONG) | (t == schema.BSDF_WARD))
    return torch.where(use_c1[:, None], ctx.c1, ctx.c0)


def transmittance_det(scene: schema.SceneData, o, d, t_max, n_steps: int = 16):
    """Deterministic transmittance along segments: analytic chord clipping
    per volume (exact for homogeneous media; grids sample the density)."""
    del n_steps
    zero = torch.zeros(o.shape[0], dtype=torch.float32, device=o.device)
    return torch.exp(-mediummod.tau_segment(scene.media, o, d, zero, t_max))


def volumetric_radiance(scene: schema.SceneData, grid: hashgrid.HashGrid,
                        o, d, t_max, radius, n_steps: int = 16):
    """Ray-march in-scattered radiance from the medium photon map along
    camera segments (reference PointStorage::L_Volume ray-marched gather):
    L = sum_k dt * T(0,t_k) * sum_p K3(|x_k - x_p|, r) beta_p phase(w_p -> -d).
    Transmittance accumulates deterministically from sigma_t at the samples."""
    B, dev = o.shape[0], o.device
    dt = t_max / n_steps
    L = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    tau = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    r_lane = _f32(radius, dev).expand(B)
    lo_m, hi_m = mediummod.media_aabb(scene.media)
    neg_d = -d[:, None, :]
    for k in range(n_steps):
        t_k = (k + 0.5) * dt
        p_k = o + d * t_k[:, None]
        # boundary-corrected 3D kernel (see core/kernels.boundary_frac)
        b_d = torch.minimum(p_k - lo_m, hi_m - p_k).amin(-1)
        corr = 1.0 / kernelsmod.boundary_frac(b_d.clamp_min(0.0), r_lane, 3)
        sig_a, sig_s, ptype, g = mediummod.sigma_at(scene.media, p_k)
        # exact optical depth up to the sample (analytic chord clipping)
        T = torch.exp(-(tau + mediummod.tau_segment(scene.media, o, d, k * dt, t_k)))

        def accum(carry, rows, mask):
            ph_pow, ph_wi = rows[..., 3:6], rows[..., 6:9]
            is_med = (rows[..., 9:12] == 0.0).all(-1)  # medium photons
            ok = mask & is_med
            dist = torch.sqrt(vm.length_sqr(rows[..., 0:3] - p_k[:, None, :])
                              .clamp_min(0.0))
            kw = (kernelsmod.k(kernelsmod.PERLIN, dist, r_lane[:, None], dim=3)
                  * corr[:, None])
            ph = phasemod.eval_phase(ptype[:, None], g[:, None], ph_wi,
                                     neg_d.expand(ph_wi.shape))
            contrib = ph_pow * (kw * ph)[..., None]
            return carry + torch.where(ok[..., None], contrib, 0.0).sum(1)

        inscatter = hashgrid.gather_neighbors(
            grid, p_k, r_lane, accum, torch.zeros((B, 3), dtype=torch.float32,
                                                  device=dev), max_per_cell=4)
        L = L + T * inscatter * dt[:, None]
        tau = tau + mediummod.tau_segment(scene.media, o, d, k * dt, (k + 1) * dt)
    return L


class PixelStats(NamedTuple):
    """Per-pixel progressive photon-mapping statistics (Hachisuka SPPM;
    reference PPPMTracer.h k_AdaptiveStruct): squared gather radius, photon
    count (alpha-weighted), accumulated flux numerator tau."""
    r2: Tensor    # (P,)
    n: Tensor     # (P,)
    tau: Tensor   # (P, 3)


def eye_pass(scene: schema.SceneData, film: filmmod.Film, grid: hashgrid.HashGrid,
             vol_grid, pass_idx, w: int, h: int, radius, n_emitted: float,
             max_depth: int, active_types, kernel_type: int = kernelsmod.PERLIN,
             with_volume: bool = False, vol_est: str = "beamgrid",
             vol_max_per_cell: int = 16, ppm_state=None, alpha: float = 2.0 / 3.0,
             final_gather: bool = False, pixel_idx: Tensor = None):
    """Camera walk to the first smooth vertex (through specular chains), then
    one density-estimation gather at that vertex. Direct emission is added
    analytically (hit emitters / env).

    With ppm_state (PixelStats) the gather uses per-pixel adaptive kNN radii
    with Hachisuka's progressive statistics (reference PPPMTracer.h:29-146);
    the gathered flux accumulates in the state's tau and the function
    returns (film, new_state). With final_gather the walk samples one extra
    bounce at the first smooth vertex and density-estimates there instead,
    while the vertex itself gets NEE direct lighting
    (PPPMTracer_EyePass.cu:16-40). pixel_idx restricts the walk to a pixel
    subset."""
    return _eye_walk(scene, film, grid, vol_grid, pass_idx, w, h, radius,
                     n_emitted, max_depth, active_types, kernel_type,
                     with_volume, vol_est, vol_max_per_cell, ppm_state, alpha,
                     final_gather, pixel_idx)[0]


def _eye_walk(scene, film, grid, vol_grid, pass_idx, w, h, radius, n_emitted,
              max_depth, active_types, kernel_type=kernelsmod.PERLIN,
              with_volume=False, vol_est="beamgrid", vol_max_per_cell=16,
              ppm_state=None, alpha=2.0 / 3.0, final_gather=False,
              pixel_idx=None):
    """eye_pass' walk; returns (its output, the int64 count of rays traced
    with tmax > 0, the DDA steps walked at each depth)."""
    del n_emitted
    dev = scene.device
    types = tuple(active_types)
    adaptive = ppm_state is not None
    if pixel_idx is None:
        pixel_idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    B = pixel_idx.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    radius = _f32(radius, dev)
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0,
                                                     pass_idx, w, h)
    zero = torch.zeros(B, **f32)
    L = torch.zeros((B, 3), **f32)
    beta = torch.ones((B, 3), **f32)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    gathered = torch.zeros(B, dtype=torch.bool, device=dev)
    # the stored gather vertex
    gv_p = gv_ns = gv_albedo = gv_beta = torch.zeros((B, 3), **f32)
    n_smooth = torch.zeros(B, dtype=torch.int32, device=dev)
    nrays = torch.zeros((), dtype=torch.int64, device=dev)
    dda_steps = []
    if with_volume:
        seg_max = 2.0 * (scene.world_hi - scene.world_lo).amax()

    for depth in range(max_depth):
        trace_rays = rays._replace(tmax=torch.where(active, rays.tmax, 0.0))
        nrays = nrays + active.sum()
        hit = traversal8.intersect_scene(scene.geom, trace_rays)
        it0 = dda.iterations
        if with_volume:
            # inactive lanes get a zero-length segment, so the DDA walk
            # stops once the live lanes have left the grid
            t_seg = torch.where(hit.valid, hit.t, seg_max)
            t_seg = torch.where(active, t_seg, 0.0)
            # in-scattered radiance gathered along this segment, then
            # attenuate the throughput (the reference's
            # PPPMTracer<VolEstimator> template parameter)
            if vol_est == ve.VOL_BEAMGRID:
                Lv, Tr = ve.radiance_beamgrid(scene, vol_grid, rays.o, rays.d,
                                              t_seg, radius,
                                              max_per_cell=vol_max_per_cell)
            elif vol_est == ve.VOL_BEAMBEAM:
                Lv, Tr = ve.radiance_beambeam(scene, vol_grid, rays.o, rays.d,
                                              t_seg, radius,
                                              max_per_cell=vol_max_per_cell)
            else:  # PointStorage: quadrature marching with 3D-kernel gathers
                n_march = 16 if depth == 0 else 8
                Lv = volumetric_radiance(scene, vol_grid, rays.o, rays.d, t_seg,
                                         radius, n_steps=n_march)
                Tr = transmittance_det(scene, rays.o, rays.d, t_seg)
            L = L + torch.where(active[:, None], beta * Lv, 0.0)
            beta = beta * Tr
        dda_steps.append(dda.iterations - it0)
        miss = active & ~hit.valid
        env = lightsmod.eval_environment(scene, rays.d)
        env_ok = miss & (n_smooth == 0) if final_gather else miss
        L = L + torch.where(env_ok[:, None], beta * env, 0.0)
        si = shading.fill_dg(scene.geom, trace_rays, hit, flip_to_ray=False)
        alive = active & hit.valid
        le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
        # with final gathering, emission past the first smooth vertex is
        # already estimated by that vertex's NEE
        le_ok = alive & (n_smooth == 0) if final_gather else alive
        L = L + torch.where(le_ok[:, None], beta * le, 0.0)

        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)
        smooth_hit = alive & ~bsdfmod.is_delta_only(ctx)
        n_smooth2 = n_smooth + smooth_hit.to(torch.int32)
        if final_gather:
            gather_here = smooth_hit & (n_smooth2 >= 2) & ~gathered
            nee_here = smooth_hit & (n_smooth2 == 1)
            ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
            lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), types)
            do_sh = nee_here & (vm.length_sqr(lob.f) > 0)
            shadow = traversal.Rays(
                o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d,
                tmin=zero, tmax=torch.where(do_sh, ed.dist * 0.999, 0.0))
            nrays = nrays + do_sh.sum()
            occ = traversal8.intersect_scene(scene.geom, shadow, any_hit=True).valid
            L = L + torch.where((nee_here & ~occ)[:, None],
                                beta * lob.f * ed.radiance_over_pdf, 0.0)
        else:
            gather_here = smooth_hit & ~gathered
        n_smooth = n_smooth2
        gh = gather_here[:, None]
        gv_p = torch.where(gh, si.p, gv_p)
        gv_ns = torch.where(gh, si.ns, gv_ns)
        gv_albedo = torch.where(gh, diffuse_albedo(ctx), gv_albedo)
        gv_beta = torch.where(gh, beta, gv_beta)
        gathered = gathered | gather_here

        # continue through delta surfaces (and, with final gathering, one
        # sampled bounce past the first smooth vertex)
        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, types)
        wo_world = frame.to_world(s.wo)
        beta = beta * s.weight
        active = alive & ~gathered & (s.weight.abs().amax(-1) > 0)
        rays = traversal.Rays(o=shading.offset_ray_origin(si.p, si.ng, wo_world),
                              d=wo_world, tmin=zero, tmax=zero + 1e30)

    if adaptive:
        # ---- per-pixel adaptive kNN radii (stochastic progressive PM) ----
        r_lane = torch.sqrt(ppm_state.r2.clamp_min(1e-20))

        def accum_a(carry, rows, mask):
            flux, M = carry
            ph_pos, ph_pow, ph_wi, ph_n = (rows[..., 0:3], rows[..., 3:6],
                                           rows[..., 6:9], rows[..., 9:12])
            ns_ = gv_ns[:, None, :]
            d2 = vm.length_sqr(ph_pos - gv_p[:, None, :])
            ok = (mask & (vm.dot(ph_n, ns_) > 0.5) & (vm.dot(ph_wi, ns_) > 0.0)
                  & (d2 <= (r_lane * r_lane)[:, None]))
            # smooth-kernel flux in Hachisuka's count units (K2 * pi r^2)
            kw = (kernelsmod.k(kernel_type, torch.sqrt(d2.clamp_min(0.0)),
                               r_lane[:, None], dim=2)
                  * (math.pi * r_lane * r_lane)[:, None])
            flux = flux + torch.where(ok[..., None], ph_pow * kw[..., None],
                                      0.0).sum(1)
            return flux, M + ok.to(torch.float32).sum(1)

        flux, M = hashgrid.gather_neighbors(
            grid, gv_p, r_lane, accum_a, (torch.zeros((B, 3), **f32), zero))
        # outgoing radiance numerator; the 1/(pi r^2 n_passes) lives in develop
        flux = torch.where(gathered[:, None],
                           flux * gv_albedo * INV_PI * gv_beta, 0.0)
        M = torch.where(gathered, M, 0.0)
        N = ppm_state.n
        ratio = torch.where(M > 0, (N + alpha * M) / (N + M).clamp_min(1e-9), 1.0)
        new_state = PixelStats(r2=ppm_state.r2 * ratio, n=N + alpha * M,
                               tau=(ppm_state.tau + flux) * ratio[:, None])
        film = filmmod.add_samples(film, px, py, L * wt)
        return (film, new_state), nrays, dda_steps

    # ---- single kernel-weighted gather at the stored vertices ----
    r_lane = radius.expand(B)

    def accum(carry, rows, mask):
        ph_pos, ph_pow, ph_wi, ph_n = (rows[..., 0:3], rows[..., 3:6],
                                       rows[..., 6:9], rows[..., 9:12])
        ns_ = gv_ns[:, None, :]
        ok = mask & (vm.dot(ph_n, ns_) > 0.5) & (vm.dot(ph_wi, ns_) > 0.0)
        dist = torch.sqrt(vm.length_sqr(ph_pos - gv_p[:, None, :]).clamp_min(0.0))
        kw = kernelsmod.k(kernel_type, dist, r_lane[:, None], dim=2)
        contrib = ph_pow * kw[..., None]
        return carry + torch.where(ok[..., None], contrib, 0.0).sum(1)

    flux = hashgrid.gather_neighbors(grid, gv_p, r_lane, accum,
                                     torch.zeros((B, 3), **f32))
    Lg = gv_albedo * INV_PI * flux
    L = L + torch.where(gathered[:, None], gv_beta * Lg, 0.0)
    return filmmod.add_samples(film, px, py, L * wt), nrays, dda_steps


def _is_medium_row(rows: Tensor) -> Tensor:
    return (rows[:, 9:12] == 0.0).all(-1)  # medium photons: normal = 0


def _build_surface_grid(rows, valid, lo, hi, cell):
    keep = valid & ~_is_medium_row(rows)
    return hashgrid.build_grid(rows, rows[:, 0:3], keep, lo, hi, cell)


def _build_vol_grid_point(rows, valid, lo, hi, cell):
    keep = valid & _is_medium_row(rows)
    return hashgrid.build_grid(rows, rows[:, 0:3], keep, lo, hi, cell)


def _build_vol_grid_ball(rows, valid, radius, lo, hi):
    keep = valid & _is_medium_row(rows)
    # only the 9 columns the beam estimator reads (pos/power/wi)
    return dda.build_ball_grid(rows[:, 0:9], rows[:, 0:3], keep, radius, lo, hi)


def develop_image(film: filmmod.Film, ppm_state, n_passes: int, w: int,
                  h: int) -> Tensor:
    """The film's image, plus with adaptive radii (ppm_state) each pixel's
    gathered flux tau / (passes * pi * r2)."""
    img = filmmod.develop(film)
    if ppm_state is not None:
        denom = max(float(n_passes), 1.0) * math.pi * ppm_state.r2.clamp_min(1e-20)
        img = img + (ppm_state.tau / denom[:, None]).reshape(h, w, 3)
    return img


class PPMTracer(tracer.TracerBase):
    """Progressive photon mapper (reference PPPMTracer). The volumetric
    estimator is selectable like the reference's template parameter:
    "point" (PointStorage marching), "beamgrid" (photon-disc beam radiance
    estimate, default), or "beambeam" (photon beams x camera beam).

    Besides ``status()``: ``rays_traced_live`` (photon walk, camera walk and
    final-gather shadow rays of live lanes), ``photons_stored`` (surface,
    medium), and for the last pass ``last_pass_host_reads`` (exit tests of
    the tracking and DDA loops), ``last_pass_dda_steps`` (per eye depth) and
    ``last_vol_grid`` (rows and bytes of the volume grid)."""

    def __init__(self, scene, width, height, n_photons: Optional[int] = None,
                 max_depth: int = 6, initial_radius: Optional[float] = None,
                 alpha: float = 2.0 / 3.0, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None,
                 vol_estimator: str = "beamgrid",
                 vol_max_per_cell: Optional[int] = None,
                 adaptive_radii: bool = False, final_gather: bool = False):
        super().__init__(scene, width, height, seed=seed)
        from . import path as pathmod
        self.max_depth = max_depth
        self.n_photons = n_photons or (width * height)
        self.alpha = alpha
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        if initial_radius is None:
            meta = schema.host_meta(scene)
            diag = float(np.linalg.norm(meta["world_hi"] - meta["world_lo"]))
            initial_radius = diag * 0.01
        self.radius = float(initial_radius)
        self.photons_emitted = 0
        self.with_volume = mediummod.has_media(scene.media)
        self.vol_est = vol_estimator if self.with_volume else "point"
        self._collect_beams = self.with_volume and vol_estimator == "beambeam"
        if vol_max_per_cell is None:
            # beambeam rows are duplicated across many cells per beam: give
            # it a deeper budget (beams are thinned at build, keep_prob=0.25)
            vol_max_per_cell = 24 if vol_estimator == "beambeam" else 16
        self.vol_max_per_cell = vol_max_per_cell
        self.adaptive_radii = adaptive_radii
        self.final_gather = final_gather
        dev = scene.device
        if adaptive_radii:
            P = width * height
            self._ppm_state = PixelStats(
                r2=torch.full((P,), self.radius * self.radius, dtype=torch.float32,
                              device=dev),
                n=torch.zeros(P, dtype=torch.float32, device=dev),
                tau=torch.zeros((P, 3), dtype=torch.float32, device=dev))
        else:
            self._ppm_state = None
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._stored_dev = torch.zeros(2, dtype=torch.int64, device=dev)
        self.last_pass_host_reads = dict(tracking=0, dda=0)
        self.last_pass_dda_steps = []
        self.last_vol_grid = None

    def render_pass(self, scene, film, pass_idx):
        dev = scene.device
        reads0 = (mediummod.host_reads, dda.host_reads)
        out, nrays = _photon_walk(
            scene, self.n_photons, pass_idx, 0x9907, self.max_depth,
            self.active_types, store_medium=self.with_volume,
            collect_beams=self._collect_beams)
        rows, valid = out[0], out[1]
        is_med = _is_medium_row(rows)
        self._stored_dev = self._stored_dev + torch.stack(
            [(valid & ~is_med).sum(), (valid & is_med).sum()])
        r = _f32(self.radius, dev)
        if self.adaptive_radii:
            # per-pixel radii can exceed the global schedule (pixels that saw
            # no photons keep their radius): the 2x2x2-neighborhood query is
            # only complete when cell >= 2 * max radius
            cell = 2.0 * torch.sqrt(self._ppm_state.r2.amax())
        else:
            cell = _f32(2.0 * self.radius, dev)
        grid = _build_surface_grid(rows, valid, scene.world_lo, scene.world_hi, cell)
        if not self.with_volume:
            vol_grid = None
        elif self.vol_est == ve.VOL_BEAMGRID:
            vol_grid = _build_vol_grid_ball(rows, valid, r, scene.world_lo,
                                            scene.world_hi)
        elif self.vol_est == ve.VOL_BEAMBEAM:
            vol_grid = ve.build_beam_cells(out[2], out[3], r, scene.world_lo,
                                           scene.world_hi)
        else:
            vol_grid = _build_vol_grid_point(rows, valid, scene.world_lo,
                                             scene.world_hi, cell)
        del rows, valid, out, is_med
        if vol_grid is not None:
            self.last_vol_grid = dict(
                rows=vol_grid.data.shape[0],
                bytes=vol_grid.data.numel() * 4 + vol_grid.cell_ids.numel() * 4)
        res, erays, self.last_pass_dda_steps = _eye_walk(
            scene, film, grid, vol_grid, pass_idx, self.width, self.height, r,
            float(self.n_photons), self.max_depth, self.active_types,
            with_volume=self.with_volume, vol_est=self.vol_est,
            vol_max_per_cell=self.vol_max_per_cell,
            ppm_state=self._ppm_state, alpha=self.alpha,
            final_gather=self.final_gather)
        if self.adaptive_radii:
            film, self._ppm_state = res
        else:
            film = res
        self._rays_dev = self._rays_dev + nrays + erays
        self.last_pass_host_reads = dict(
            tracking=mediummod.host_reads - reads0[0],
            dda=dda.host_reads - reads0[1])
        # progressive radius schedule r_{i+1}^2 = r_i^2 * (i+alpha)/(i+1)
        # (drives the volumetric estimator; surface radii are per-pixel when
        # adaptive_radii)
        i = self.pass_idx + 1
        self.radius = float(self.radius * ((i + self.alpha) / (i + 1.0)) ** 0.5)
        self.photons_emitted += self.n_photons
        return film

    def develop(self):
        return develop_image(self.film, self._ppm_state, self.pass_idx,
                             self.width, self.height)

    def render(self, n_passes: int = 1):
        for _ in range(n_passes):
            self.do_pass()
        return self.develop()

    def status(self):
        s = super().status()
        s.update(photons_emitted=self.photons_emitted, radius=self.radius,
                 photons_per_second=self.photons_emitted / max(self.accum_seconds, 1e-9))
        return s

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)

    @property
    def photons_stored(self) -> tuple:
        """(surface, medium) photons stored over all passes."""
        return tuple(int(x) for x in self._stored_dev.tolist())
