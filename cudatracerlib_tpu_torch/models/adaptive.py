"""Adaptive progressive rendering: block-sampled path tracing.

Port of ``cudatracerlib_tpu/models/adaptive.py`` (the reference's
``Tracer<PROGRESSIVE>::DoPass`` with IBlockSampler and
PixelVarianceBuffer): each pass chooses blocks from the variance buffer,
renders all of their pixels in ONE ``pt_radiance`` call (no chunks), and
adds the samples to the film and the variance buffer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..scene import schema
from . import blocksampler as bs
from . import film as filmmod
from . import path as pathmod
from . import tracer

Tensor = torch.Tensor

CHOOSE_SEED = 0xB10C    # the weighted slots' RNG key


class AdaptivePathTracer(tracer.TracerBase):
    """Path tracer whose passes concentrate samples on high-variance blocks.

    ``rays_traced_live`` counts the live rays traced (int64, as
    ``path.PathTracer``'s)."""

    def __init__(self, scene, width, height, max_depth: int = 8,
                 mode: int = bs.B_VARIANCE, blocks_per_pass: Optional[int] = None,
                 select_rect=None, seed: int = 0,
                 active_types: Optional[Sequence[int]] = None):
        super().__init__(scene, width, height, seed=seed)
        if width % bs.BLOCK or height % bs.BLOCK:
            raise ValueError(f"film must be a multiple of {bs.BLOCK}")
        self.max_depth = max_depth
        self.mode = mode
        self.select_rect = tuple(select_rect) if select_rect else None
        nb = (width // bs.BLOCK) * (height // bs.BLOCK)
        self.blocks_per_pass = blocks_per_pass or nb
        self.n_det = max(self.blocks_per_pass // 2, 1)
        self.n_wt = self.blocks_per_pass - self.n_det
        if active_types is None:
            active_types = pathmod.scene_active_types(scene)
        self.active_types = tuple(active_types)
        self.vb = bs.VarianceBuffer.new(width, height, scene.device)
        self._rays_dev = torch.zeros((), dtype=torch.int64, device=scene.device)

    def render_pass(self, scene, film, pass_idx):
        film, self.vb, nrays = _adaptive_pass(
            scene, film, self.vb, pass_idx, self.width, self.height,
            self.max_depth, self.mode, self.n_det, self.n_wt,
            self.active_types, self.select_rect)
        self._rays_dev = self._rays_dev + nrays
        return film

    @property
    def rays_traced_live(self) -> int:
        return int(self._rays_dev)

    def error_map(self):
        return bs.halfbuffer_error(self.vb)


def _adaptive_pass(scene: schema.SceneData, film: filmmod.Film,
                   vb: bs.VarianceBuffer, pass_idx, w: int, h: int,
                   max_depth: int, mode: int, n_det: int, n_wt: int,
                   active_types, select_rect):
    """One pass over (n_det + n_wt) blocks. Returns the film, the variance
    buffer and the live rays the pass traced."""
    weights = bs.block_weights(vb, w, h, mode, select_rect)
    blocks = bs.choose_blocks(weights, n_det, n_wt, pass_idx, CHOOSE_SEED)
    pixel_idx = bs.block_pixels(blocks, w).to(torch.int32)
    rays, px, py, state, wt = tracer.gen_camera_rays(
        scene, pixel_idx, pass_idx, pass_idx, w, h)
    L, state, nrays, _, _, _ = pathmod.pt_radiance(
        scene, rays, state, max_depth, active_types=active_types,
        return_rays=True)
    ok = torch.ones(pixel_idx.shape[0], dtype=torch.bool, device=L.device)
    film = filmmod.add_samples(film, px, py, L * wt, mask=ok)
    vb = bs.add_samples(vb, px, py, L, torch.full_like(px, pass_idx), ok)
    return film, vb, nrays
