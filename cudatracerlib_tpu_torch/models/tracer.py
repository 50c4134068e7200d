"""Tracer framework: progressive pass loop + camera-ray generation.

Port of ``cudatracerlib_tpu/models/tracer.py`` with the box filter and the
independent PCG sampler. A pass is a Python loop over chunks of lanes
(lane = pixel sample); there is no jit.
"""
from __future__ import annotations

import time

import torch

from ..core import rng as rngmod
from ..scene import schema, sensors
from ..ops import traversal
from . import film as filmmod

Tensor = torch.Tensor


def gen_camera_rays(scene: schema.SceneData, pixel_idx: Tensor, sample_idx,
                    pass_idx, w: int, h: int, filter_type: int = 0,
                    sampler_type: int = 0):
    """Per-lane camera ray generation with box-filter pixel jitter.

    pixel_idx: (B,) flat pixel ids (y*w + x). Returns (rays, px, py,
    rng_state, weight)."""
    if filter_type != 0 or sampler_type != 0:
        raise NotImplementedError("only the box filter and the independent "
                                  "sampler are ported yet")
    state = rngmod.seed(pixel_idx, sample_idx, pass_idx)
    px = (pixel_idx % w).to(torch.int32)
    py = (pixel_idx // w).to(torch.int32)
    state, u_pix = rngmod.next_float2(state)
    state, u_lens = rngmod.next_float2(state)
    jitter = u_pix - 0.5
    p_film = torch.stack([px.to(torch.float32) + 0.5 + jitter[:, 0],
                          py.to(torch.float32) + 0.5 + jitter[:, 1]], dim=-1)
    sr = sensors.sample_ray(scene.sensor, p_film, u_lens)
    B = pixel_idx.shape[0]
    zero = torch.zeros(B, dtype=torch.float32, device=pixel_idx.device)
    rays = traversal.Rays(o=sr.o, d=sr.d, tmin=zero, tmax=zero + 1e30)
    return rays, px, py, state, sr.weight


class TracerBase:
    """Host-side pass loop: owns the film, pass counter and wall-clock stats."""

    def __init__(self, scene: schema.SceneData, width: int, height: int,
                 spp_per_pass: int = 1, seed: int = 0):
        self.scene = scene
        self.width = width
        self.height = height
        self.spp_per_pass = spp_per_pass
        self.seed = seed
        self.pass_idx = 0
        self.film = filmmod.new_film(width, height, scene.device)
        self.last_pass_seconds = 0.0
        self.accum_seconds = 0.0

    # subclasses implement: render_pass(scene, film, pass_idx) -> film
    def render_pass(self, scene, film, pass_idx):
        raise NotImplementedError

    def _sync(self):
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)

    def do_pass(self):
        t0 = time.perf_counter()
        self.film = self.render_pass(self.scene, self.film, self.pass_idx)
        self._sync()
        self.last_pass_seconds = time.perf_counter() - t0
        self.accum_seconds += self.last_pass_seconds
        self.film = self.film._replace(n_passes=self.film.n_passes + 1.0)
        self.pass_idx += 1

    def render(self, n_passes: int = 1) -> Tensor:
        for _ in range(n_passes):
            self.do_pass()
        return filmmod.develop(self.film)

    def render_batched(self, n_passes: int):
        """Run n_passes; a plain loop over do_pass (PyTorch dispatches
        eagerly, so there is no batch to fuse)."""
        for _ in range(n_passes):
            self.do_pass()
