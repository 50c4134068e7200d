"""Light tracer: particle tracing from the emitters with camera splats.

Port of ``cudatracerlib_tpu/models/lighttracer.py`` (the reference's
``Integrators/PhotonTracer.cu``): one pass walks W*H light subpaths bounce
by bounce in a Python loop, connects every emission and surface vertex to
the sensor through an any-hit shadow ray and splats the contribution into
the film. With exactly W*H light paths per pass, the splat scale of
``film.develop`` (1/n_passes) matches the path tracer's per-pixel estimator.

Each pass traces 1 + 2 * max_depth wavefronts (the emission splat, then per
bounce one closest-hit walk and one any-hit splat). The live-ray count is
an int64 tensor, ``_rays_dev``, as ``PathTracer`` keeps it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema, sensors
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import tracer

Tensor = torch.Tensor


def splat_to_camera(scene: schema.SceneData, film: filmmod.Film, p: Tensor,
                    value: Tensor, active: Tensor) -> filmmod.Film:
    """Connect points to the sensor, shadow-test, and splat value*We.
    Returns (film, the sensor record)."""
    B = p.shape[0]
    sd = sensors.sample_direct(scene.sensor, p, None)
    # occlusion between the surface point and the camera
    shadow = traversal.Rays(
        o=p + sd.d * 1e-4, d=sd.d,
        tmin=torch.zeros(B, dtype=torch.float32, device=p.device),
        tmax=torch.where(active & sd.valid, sd.dist * 0.999, 0.0))
    occ = traversal8.intersect_scene(scene.geom, shadow, any_hit=True).valid
    ok = active & sd.valid & ~occ
    contrib = value * sd.weight
    # clipped: every index stays inside the film
    px = sd.p_film[:, 0].to(torch.int32).clamp(0, film.w - 1)
    py = sd.p_film[:, 1].to(torch.int32).clamp(0, film.h - 1)
    return filmmod.splat(film, px, py, contrib, mask=ok), sd


def lt_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx, n_paths: int,
            max_depth: int, active_types: Sequence[int],
            path_ids: Tensor = None, total_paths: int = None) -> filmmod.Film:
    """Trace n_paths light subpaths; splat every vertex to the camera.

    path_ids / total_paths serve a sharded pass: each shard traces its own
    id range while the splat normalization uses the global path count."""
    return _lt_walk(scene, film, pass_idx, n_paths, max_depth, active_types,
                    path_ids, total_paths)[0]


def _lt_walk(scene, film, pass_idx, n_paths, max_depth, active_types,
             path_ids=None, total_paths=None):
    """lt_pass's walk; returns (film, the int64 count of rays traced with
    tmax > 0: walk rays of live lanes and splat shadow rays)."""
    dev = film.rgb.device
    if path_ids is None:
        path_ids = torch.arange(n_paths, dtype=torch.int32, device=dev)
    n_paths = path_ids.shape[0]
    n_total = total_paths or n_paths
    f32 = dict(dtype=torch.float32, device=dev)
    state = rngmod.seed(path_ids, pass_idx, 0x9E3779B9)
    er, state = lightsmod.sample_emitter_ray(scene, state)
    ltype = scene.lights.light_type[er.light_idx.long()]

    # splat the emission vertex itself (s=1 connection): radiance of the
    # emitter toward the camera over its position pdf
    sd_dir = sensors.sample_direct(scene.sensor, er.o, None)
    cos_l = torch.where((er.n != 0).any(dim=-1),
                        vm.dot(er.n, sd_dir.d).clamp_min(0.0), 1.0)
    em_val = (er.le * (cos_l / er.pdf_pos.clamp_min(1e-12))[:, None]
              / float(n_total) * film.w * film.h)
    is_area_or_point = ((ltype == schema.LIGHT_POINT) | (ltype == schema.LIGHT_DIFFUSE)
                        | (ltype == schema.LIGHT_SPOT))
    film, sd = splat_to_camera(scene, film, er.o, em_val, is_area_or_point)
    nrays = (is_area_or_point & sd.valid).sum()

    beta = er.power / float(n_total) * film.w * film.h
    zero = torch.zeros(n_paths, **f32)
    rays = traversal.Rays(o=er.o + er.d * 1e-4, d=er.d, tmin=zero, tmax=zero + 1e30)
    active = torch.ones(n_paths, dtype=torch.bool, device=dev)
    types = tuple(active_types)

    for depth in range(max_depth):
        trace_rays = rays._replace(tmax=torch.where(active, rays.tmax, 0.0))
        nrays = nrays + active.sum()
        hit = traversal8.intersect_scene(scene.geom, trace_rays)
        si = shading.fill_dg(scene.geom, trace_rays, hit, flip_to_ray=False)
        alive = active & hit.valid

        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)

        # connect this vertex to the camera: importance transport
        sd_probe = sensors.sample_direct(scene.sensor, si.p, None)
        wo_cam_local = frame.to_local(sd_probe.d)
        lob = bsdfmod.evaluate(ctx, wi_local, wo_cam_local, types)
        film, sd = splat_to_camera(
            scene, film, shading.offset_ray_origin(si.p, si.ng, sd_probe.d),
            beta * lob.f, alive)
        nrays = nrays + (alive & sd.valid).sum()

        # continue the walk (BSDF sampling is symmetric for these materials)
        s, state = bsdfmod.sample_with_rng(ctx, wi_local, state, types)
        wo_world = frame.to_world(s.wo)
        beta = beta * s.weight
        alive = alive & (s.weight.abs().amax(dim=-1) > 0) & (depth + 1 < max_depth)
        state, u_rr = rngmod.next_float(state)
        if depth >= 3:
            q = beta.amax(dim=-1).clamp(0.05, 0.95)
            survive = u_rr < q
            beta = torch.where(survive[:, None], beta / q.clamp_min(1e-6)[:, None], beta)
            alive = alive & survive
        rays = traversal.Rays(o=shading.offset_ray_origin(si.p, si.ng, wo_world),
                              d=wo_world, tmin=zero, tmax=zero + 1e30)
        beta = torch.where(alive[:, None], beta, 0.0)
        active = alive
    return film, nrays


class LightTracer(tracer.TracerBase):
    """Pure light tracing (reference PhotonTracer): the image forms entirely
    from splats."""

    def __init__(self, scene, width, height, max_depth: int = 8,
                 n_paths: Optional[int] = None, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, seed=seed)
        from . import path as pathmod
        self.max_depth = max_depth
        self.n_paths = n_paths or (width * height)
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=scene.device)

    def render_pass(self, scene, film, pass_idx):
        film, nrays = _lt_walk(scene, film, pass_idx, self.n_paths,
                               self.max_depth, self.active_types)
        self._rays_dev = self._rays_dev + nrays
        # weight 1 everywhere so develop() averages the (empty) rgb buffer
        return film._replace(weight=torch.ones_like(film.weight))

    @property
    def rays_traced_live(self) -> int:
        """Total rays actually traced (live lanes only)."""
        return int(self._rays_dev)
