"""GameTracer: pseudo-realtime GI by path-space filtering.

Port of ``cudatracerlib_tpu/models/game.py`` (the reference's
``Integrators/GameTracer`` with ``Kernel/PathSpaceFilteringBuffer``): each
frame traces the camera rays (coherent) and one NEE shadow ray per primary
hit, caches the hit's incident direct light as (position, light, normal)
rows (ops/psf.cache_rows) in the sort-based hash grid (ops/hashgrid.py,
cells of twice the radius), sums them at each primary hit within a
footprint-adaptive radius (ops/psf.psf_gather: the plain gather over the
whole (B, 128, 12) neighbourhood on the CPU, one kernel on the card), and blends
the result with the previous frame's film where the pixel's hit point and
normal stayed put.

Four hard tests sit on floats (the gather's d^2 <= r^2, the normal test
> 0.8, and the history's distance < r and normal > 0.9): a hit that moves
by a last bit can move a sample or a pixel's history across them.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core import vecmath as vm
from ..ops import hashgrid, psf, shading, traversal, traversal8
from ..scene import schema
from ..utils import timers
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import tracer

Tensor = torch.Tensor


def psf_pass(scene: schema.SceneData, film: filmmod.Film, prev_p, prev_ns,
             pass_idx, w: int, h: int, radius: float, temporal_alpha: float,
             active_types, iters_ctr: Tensor):
    """One realtime-GI frame. radius is the cap; each pixel's gather radius
    adapts to its projected footprint, and temporal history is dropped per
    pixel where the hit point or normal moved. Returns (film, hit points,
    shading normals, live rays traced), and adds the traversal steps of its
    camera and shadow rays to the int64 `iters_ctr` in place. Its stages are
    spans of ``utils/timers.RECORDER``: ``ctl.surface`` (the hit's geometry
    and BSDF context), ``ctl.nee`` (the light sample and its shadow ray)
    and ``ctl.filter`` (the hash grid, the gather and the temporal blend)."""
    B = w * h
    dev = film.rgb.device
    pixel_idx = torch.arange(B, dtype=torch.int32, device=dev)
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0, pass_idx, w, h)
    hit, it_cam, _, _ = traversal8.intersect_scene(scene.geom, rays, coherent=True,
                                                   with_iters=True)
    with timers.span("ctl.surface"):
        si = shading.fill_dg(scene.geom, rays, hit, flip_to_ray=False)
        alive = hit.valid
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=active_types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)

    # one-sample incident direct light at the primary hit -> cache entry
    with timers.span("ctl.nee"):
        ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
        lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), active_types)
        zero = torch.zeros(B, dtype=torch.float32, device=dev)
        shadow = traversal.Rays(o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d,
                                tmin=zero, tmax=torch.where(alive, ed.dist * 0.999, 0.0))
        occ_hit, it_sh, _, _ = traversal8.intersect_scene(scene.geom, shadow, any_hit=True,
                                                          with_iters=True)
        occ = occ_hit.valid
        Li = torch.where((alive & ~occ)[:, None], lob.f * ed.radiance_over_pdf, 0.0)

    with timers.span("ctl.filter"):
        grid = hashgrid.build_grid(psf.cache_rows(si.p, Li, si.ns), si.p, alive,
                                   scene.world_lo, scene.world_hi,
                                   torch.tensor(2.0 * radius, dtype=torch.float32,
                                                device=dev))

        # footprint-adaptive gather radius: ~4 projected pixels at the hit,
        # capped by the global radius (cells of 2*radius keep queries complete)
        params = scene.sensor.params
        cone = 2.0 * torch.tan(0.5 * params[0]) / params[5].clamp_min(1.0)
        r_lane = (4.0 * cone * hit.t).clamp(radius / 16.0, radius)

        acc, cnt = psf.psf_gather(grid, si.p, si.ns, r_lane)
        filtered = acc / cnt.clamp_min(1.0)[:, None]
        le = lightsmod.eval_hit_emitter(scene, si.light_id, si.ng, si.wi)
        Lout = torch.where(alive[:, None], filtered + le,
                           lightsmod.eval_environment(scene, rays.d))

        # temporal accumulation with per-pixel invalidation: history survives
        # only where the primary hit stayed on the same surface point
        same_pt = vm.length(si.p - prev_p.reshape(B, 3)) < r_lane
        same_n = vm.dot(si.ns, prev_ns.reshape(B, 3)) > 0.9
        valid_hist = (film.n_passes > 0) & same_pt & same_n
        a_eff = torch.where(valid_hist, temporal_alpha, 1.0).reshape(h, w, 1)
        blended = film.rgb * (1 - a_eff) + Lout.reshape(h, w, 3) * a_eff
    nrays = B + (shadow.tmax > 0).sum()
    iters_ctr.add_(it_cam + it_sh)
    return (film._replace(rgb=blended, weight=torch.ones_like(film.weight)),
            si.p.reshape(h, w, 3), si.ns.reshape(h, w, 3), nrays)


class GameTracer(tracer.TracerBase):
    """Primary hits + path-space-filtered direct light with temporal reuse.

    ``rays_traced_live`` counts the camera rays and the shadow rays that
    were traced, ``_iters_dev`` their traversal steps (int64, on the
    device)."""

    def __init__(self, scene, width, height, radius: Optional[float] = None,
                 temporal_alpha: float = 0.25, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, seed=seed)
        from . import path as pathmod
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        if radius is None:
            meta = schema.host_meta(scene)
            diag = float(np.linalg.norm(meta["world_hi"] - meta["world_lo"]))
            radius = diag * 0.01
        self.radius = float(radius)
        self.temporal_alpha = temporal_alpha
        self.active_types = tuple(active_types)
        dev = scene.device
        self._prev_p = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        self._prev_ns = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._iters_dev = torch.zeros((), dtype=torch.int64, device=dev)

    def render_pass(self, scene, film, pass_idx):
        film, self._prev_p, self._prev_ns, nrays = psf_pass(
            scene, film, self._prev_p, self._prev_ns, pass_idx, self.width,
            self.height, self.radius, self.temporal_alpha, self.active_types,
            self._iters_dev)
        self._rays_dev = self._rays_dev + nrays
        return film

    @property
    def rays_traced_live(self) -> int:
        return int(self._rays_dev)
