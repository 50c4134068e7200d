"""PrimTracer: primary-hit AOV renderer.

Port of ``cudatracerlib_tpu/models/prim.py`` (the reference's
``Integrators/PrimTracer.h``: depth, normals, uv, barycentrics, first-hit
emission, albedo and the first-non-delta AOVs). One pass traces one camera
ray per pixel; the first-non-delta modes walk through up to 6 delta bounces
(mirror, glass) to the first smooth surface. The traversal counters are
int64 tensors on the scene's device, as ``PathTracer`` keeps them.
"""
from __future__ import annotations

import torch

from ..core import rng as rngmod
from ..core import vecmath as vm
from ..ops import shading, traversal, traversal8
from ..scene import schema
from . import bsdf as bsdfmod
from . import film as filmmod
from . import lights as lightsmod
from . import tracer
from .path import scene_active_types

# Draw modes (named like the reference's PrimTracer enum)
D_LINEAR_DEPTH = 0
D_D3D_DEPTH = 1
D_NORMAL_GEO = 2
D_NORMAL_SHADE = 3
D_UV = 4
D_BARY = 5
D_MAT_ID = 6
D_LIGHT_LE = 7      # first-hit emitted radiance
D_ALBEDO = 8        # first-hit diffuse reflectance approximation
D_UVSET = 9
D_FIRST_F = 10      # BSDF response for one sampled direction at the first hit
D_FIRST_DIRECT = 11  # one-sample direct lighting at the first hit
# first-NON-DELTA variants (reference PrimTracer.h:7-8): the walk continues
# through specular chains and the AOV is taken at the first smooth surface
D_ND_NORMAL = 12
D_ND_DEPTH = 13
D_ND_ALBEDO = 14
D_ND_MODES = (D_ND_NORMAL, D_ND_DEPTH, D_ND_ALBEDO)


class PrimTracer(tracer.TracerBase):
    progressive = False

    def __init__(self, scene, width, height, draw_mode: int = D_NORMAL_SHADE,
                 **kw):
        super().__init__(scene, width, height, **kw)
        self.draw_mode = draw_mode
        dev = scene.device
        self._iters_dev = torch.zeros((), dtype=torch.int64, device=dev)
        self._rows_dev = torch.zeros((), dtype=torch.int64, device=dev)

    def render_pass(self, scene, film, pass_idx):
        film, it, rw = _prim_pass(scene, film, pass_idx, self.draw_mode,
                                  self.width, self.height)
        self._iters_dev = self._iters_dev + it
        self._rows_dev = self._rows_dev + rw
        return film

    def _debug_lane(self, pixel_idx):
        rays, px, py, state, wt = tracer.gen_camera_rays(
            self.scene, pixel_idx, 0, 0, self.width, self.height)
        hit = traversal8.intersect_scene(self.scene.geom, rays, coherent=True)
        si = shading.fill_dg(self.scene.geom, rays, hit)
        return dict(ray_o=rays.o, ray_d=rays.d, t=hit.t, tri=hit.tri,
                    p=si.p, ns=si.ns, uv=si.uv, mat=si.mat_id)


def _prim_pass(scene: schema.SceneData, film: filmmod.Film, pass_idx,
               draw_mode: int, w: int, h: int):
    """One AOV pass; returns (film, traversal steps, rows read), int64."""
    dev = film.rgb.device
    pixel_idx = torch.arange(w * h, dtype=torch.int32, device=dev)
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0,
                                                     pass_idx, w, h)
    hit, niters, nrows, _ = traversal8.intersect_scene(
        scene.geom, rays, coherent=True, with_iters=True)
    si = shading.fill_dg(scene.geom, rays, hit)
    if draw_mode in D_ND_MODES:
        # continue through delta lobes to the first smooth vertex, tracking
        # the accumulated distance (reference first-non-delta AOVs)
        types = scene_active_types(scene)
        B = w * h
        state = rngmod.seed(pixel_idx, 0, 0xD0)
        t_acc = hit.t
        zero = torch.zeros(B, dtype=torch.float32, device=dev)
        for _ in range(6):
            ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
            delta = si.valid & bsdfmod.is_delta_only(ctx)
            frame = si.frame()
            s_, state = bsdfmod.sample_with_rng(ctx, frame.to_local(si.wi), state,
                                                types)
            wo_world = frame.to_world(s_.wo)
            nxt = traversal.Rays(
                o=shading.offset_ray_origin(si.p, si.ng, wo_world), d=wo_world,
                tmin=zero, tmax=torch.where(delta, 1e30, 0.0))
            hit2, i2, r2, _ = traversal8.intersect_scene(scene.geom, nxt,
                                                         with_iters=True)
            niters = niters + i2
            nrows = nrows + r2
            si2 = shading.fill_dg(scene.geom, nxt, hit2)
            adv = delta & hit2.valid
            t_acc = torch.where(adv, t_acc + hit2.t, t_acc)
            si = shading.SurfaceInteraction(*(
                None if old is None else torch.where(
                    adv.reshape(adv.shape + (1,) * (old.ndim - 1)), new, old)
                for new, old in zip(si2, si)))
        hit = hit._replace(t=t_acc)
        base_mode = {D_ND_NORMAL: D_NORMAL_SHADE, D_ND_DEPTH: D_LINEAR_DEPTH,
                     D_ND_ALBEDO: D_ALBEDO}[draw_mode]
        val = _aov(scene, rays, hit, si, base_mode)
    else:
        val = _aov(scene, rays, hit, si, draw_mode)
    val = torch.where(si.valid[:, None], val, 0.0)
    return filmmod.add_samples(film, px, py, val), niters, nrows


def _aov(scene, rays, hit, si: shading.SurfaceInteraction, mode: int):
    if mode == D_LINEAR_DEPTH:
        # 2x the scene diagonal: the camera is typically outside the bounds
        far = 2.0 * vm.length(scene.world_hi - scene.world_lo)
        d = (hit.t / far).clamp(0.0, 1.0)
        return d[:, None].expand(-1, 3)
    if mode == D_D3D_DEPTH:
        near, far = 1.0, 2.0 * vm.length(scene.world_hi - scene.world_lo)
        d = (far / (far - near)) * (1.0 - near / hit.t.clamp_min(1e-6))
        return d.clamp(0, 1)[:, None].expand(-1, 3)
    if mode == D_NORMAL_GEO:
        return si.ng * 0.5 + 0.5
    if mode == D_NORMAL_SHADE:
        return si.ns * 0.5 + 0.5
    if mode in (D_UV, D_UVSET):
        return torch.cat([torch.remainder(si.uv, 1.0),
                          torch.zeros_like(si.uv[:, :1])], -1)
    if mode == D_BARY:
        b = si.bary
        return torch.stack([1 - b[:, 0] - b[:, 1], b[:, 0], b[:, 1]], -1)
    if mode == D_MAT_ID:
        c = rngmod.pcg_hash(si.mat_id)
        return torch.stack([(c & 0xFF).to(torch.float32) / 255.0,
                            ((c >> 8) & 0xFF).to(torch.float32) / 255.0,
                            ((c >> 16) & 0xFF).to(torch.float32) / 255.0], -1)
    if mode == D_LIGHT_LE:
        params = scene.lights.params
        lid = si.light_id.clamp(0, params.shape[0] - 1).long()
        return torch.where((si.light_id >= 0)[:, None], params[lid, 3:6], 0.0)
    if mode == D_ALBEDO:
        mp = scene.materials.params
        return mp[si.mat_id.clamp(0, mp.shape[0] - 1).long(), 0:3]
    if mode in (D_FIRST_F, D_FIRST_DIRECT):
        types = scene_active_types(scene)
        B = si.p.shape[0]
        state = rngmod.seed(torch.arange(B, dtype=torch.int32, device=si.p.device),
                            0, 0xA0)
        ctx = bsdfmod.gather_ctx(scene, si.mat_id, si.uv, active_types=types)
        frame = si.frame()
        wi_local = frame.to_local(si.wi)
        if mode == D_FIRST_F:
            s_, state = bsdfmod.sample_with_rng(ctx, wi_local, state, types)
            return s_.weight
        ed, state = lightsmod.sample_emitter_direct(scene, si.p, state)
        lob = bsdfmod.evaluate(ctx, wi_local, frame.to_local(ed.d), types)
        shadow = traversal.Rays(
            o=shading.offset_ray_origin(si.p, si.ng, ed.d), d=ed.d,
            tmin=torch.zeros(B, dtype=torch.float32, device=si.p.device),
            tmax=torch.where(si.valid, ed.dist * 0.999, 0.0))
        occ = traversal8.intersect_scene(scene.geom, shadow, any_hit=True).valid
        return torch.where((si.valid & ~occ)[:, None],
                           lob.f * ed.radiance_over_pdf, 0.0)
    raise ValueError(f"unknown draw mode {mode}")
