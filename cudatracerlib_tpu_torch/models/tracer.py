"""Tracer framework: progressive pass loop + camera-ray generation.

Port of ``cudatracerlib_tpu/models/tracer.py``. A pass is a Python loop
over chunks of lanes (lane = pixel sample); there is no jit. Camera rays
take the box, tent or Gaussian filter by filter importance sampling, and
the independent, stratified or Sobol' sampler (models/samplers.py).
"""
from __future__ import annotations

import time

import torch

from ..core import rng as rngmod
from ..scene import schema, sensors
from ..ops import traversal
from ..utils import timers
from . import film as filmmod

Tensor = torch.Tensor


def gen_camera_rays(scene: schema.SceneData, pixel_idx: Tensor, sample_idx,
                    pass_idx, w: int, h: int, filter_type: int = 0,
                    sampler_type: int = 0):
    """Per-lane camera ray generation with filter-importance-sampled jitter.

    pixel_idx: (B,) flat pixel ids (y*w + x). Returns (rays, px, py,
    rng_state, weight). sampler_type: 0 = independent PCG, 1 = stratified,
    2 = Sobol', applied to the camera dims (0-1 pixel jitter, 2-3 lens);
    the PCG stream advances past its four draws either way."""
    state = rngmod.seed(pixel_idx, sample_idx, pass_idx)
    px = (pixel_idx % w).to(torch.int32)
    py = (pixel_idx // w).to(torch.int32)
    state, u_pix = rngmod.next_float2(state)
    state, u_lens = rngmod.next_float2(state)
    if sampler_type != 0:
        from . import samplers
        with timers.span("ctl.sampler"):
            u_pix = samplers.sample_2d(sampler_type, pixel_idx, sample_idx, 0)
            u_lens = samplers.sample_2d(sampler_type, pixel_idx, sample_idx, 2)
    jitter = _filter_jitter(filter_type, u_pix)
    p_film = torch.stack([px.to(torch.float32) + 0.5 + jitter[:, 0],
                          py.to(torch.float32) + 0.5 + jitter[:, 1]], dim=-1)
    sr = sensors.sample_ray(scene.sensor, p_film, u_lens)
    B = pixel_idx.shape[0]
    zero = torch.zeros(B, dtype=torch.float32, device=pixel_idx.device)
    rays = traversal.Rays(o=sr.o, d=sr.d, tmin=zero, tmax=zero + 1e30)
    return rays, px, py, state, sr.weight


def _filter_jitter(filter_type: int, u: Tensor) -> Tensor:
    """Filter importance sampling: jitter offsets in pixels, centred at 0.

    0 = box (1px), 1 = tent (2px), 2 = Gaussian (sigma 0.5, clipped to 2)."""
    from ..core import warp
    if filter_type == 1:
        return warp.square_to_tent(u)
    if filter_type == 2:
        return (warp.square_to_std_normal(u) * 0.5).clamp(-2.0, 2.0)
    return u - 0.5


class TracerBase:
    """Host-side pass loop: owns the film, pass counter and wall-clock stats.

    Each pass is the span ``ctl.pass`` of ``utils/timers.RECORDER`` (with the
    pass index as its request id) while a profiler records; the host seconds
    of a tracer's first pass go to ``RECORDER.first_pass_s``."""

    progressive = True

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
        self._first_pass = True

    # subclasses implement: render_pass(scene, film, pass_idx) -> film
    def render_pass(self, scene, film, pass_idx):
        raise NotImplementedError

    def _sync(self):
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)

    def do_pass(self):
        t0 = time.perf_counter()
        with timers.RECORDER.pass_block(self.pass_idx):
            self.film = self.render_pass(self.scene, self.film, self.pass_idx)
            self._sync()
        self.last_pass_seconds = time.perf_counter() - t0
        if self._first_pass:
            timers.RECORDER.first_pass_s = self.last_pass_seconds
            self._first_pass = False
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

    def debug_pixel(self, x: int, y: int):
        """Re-run the integrator for one pixel (reference Tracer::Debug) on
        a one-lane batch for inspection."""
        pix = torch.tensor([y * self.width + x], dtype=torch.int32,
                           device=self.scene.device)
        return self._debug_lane(pix)

    def _debug_lane(self, pixel_idx):
        raise NotImplementedError

    def status(self) -> dict:
        spp = self.pass_idx * self.spp_per_pass
        return dict(passes=self.pass_idx, spp=spp,
                    seconds=self.accum_seconds,
                    spp_per_second=spp / max(self.accum_seconds, 1e-9))
