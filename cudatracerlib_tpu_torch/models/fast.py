"""FastTracer: primary-visibility and depth renderer.

Port of ``cudatracerlib_tpu/models/fast.py`` (the reference's
``Integrators/FastTracer.cu``): one coherent traversal of the camera rays a
pass, producing camera depth or binary visibility as fast as the
intersector allows. Used as the traversal-throughput probe: on a treelet
table the camera rays take the coherent visit budget (K2 at V=6).
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..ops import traversal8
from . import film as filmmod
from . import tracer

MODE_DEPTH, MODE_VISIBILITY = 0, 1


class FastTracer(tracer.TracerBase):
    progressive = False

    def __init__(self, scene, width, height, mode: int = MODE_DEPTH, **kw):
        super().__init__(scene, width, height, **kw)
        self.mode = mode

    def render_pass(self, scene, film, pass_idx):
        return _fast_pass(scene, film, pass_idx, self.width, self.height, self.mode)


def _fast_pass(scene, film, pass_idx, w, h, mode):
    pixel_idx = torch.arange(w * h, dtype=torch.int32, device=film.rgb.device)
    rays, px, py, state, wt = tracer.gen_camera_rays(scene, pixel_idx, 0, pass_idx, w, h)
    hit = traversal8.intersect_scene(scene.geom, rays, coherent=True)
    if mode == MODE_VISIBILITY:
        v = hit.valid.to(torch.float32)
    else:
        far = vm.length(scene.world_hi - scene.world_lo)
        v = torch.where(hit.valid, 1.0 - (hit.t / far).clamp(0, 1), 0.0)
    return filmmod.add_samples(film, px, py, v[:, None].expand(-1, 3))
