"""Film / image accumulation buffers.

Port of ``cudatracerlib_tpu/models/film.py``. Unlike the JAX package's
functional updates, ``add_samples`` adds into the film's tensors in place
(``index_add_``) and returns the same film: a pass then allocates no new
image buffers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import schema

Tensor = torch.Tensor


class Film(NamedTuple):
    rgb: Tensor      # (H, W, 3) f32 weighted sample sum
    weight: Tensor   # (H, W) f32 sum of sample weights
    splat: Tensor    # (H, W, 3) f32 splat sum (light tracing / BDPT t=1)
    n_passes: float  # number of completed passes (for splat scale)

    @property
    def h(self):
        return self.rgb.shape[0]

    @property
    def w(self):
        return self.rgb.shape[1]


def new_film(w: int, h: int, device="cuda") -> Film:
    """An empty film on `device` (the card unless the caller asks for the
    CPU; raises without one)."""
    device = schema.resolve_device(device)
    return Film(rgb=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
                weight=torch.zeros((h, w), dtype=torch.float32, device=device),
                splat=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
                n_passes=0.0)


def add_samples(film: Film, pixel_x: Tensor, pixel_y: Tensor, value: Tensor,
                weight=None, mask=None) -> Film:
    """Add sample values at integer pixel coords (in place; coords must lie
    inside the film)."""
    B = pixel_x.shape[0]
    if weight is None:
        weight = torch.ones(B, dtype=torch.float32, device=value.device)
    if mask is not None:
        weight = torch.where(mask, weight, 0.0)
    value = torch.where(torch.isfinite(value), value, 0.0) * weight[:, None]
    flat = (pixel_y * film.w + pixel_x).long()
    film.rgb.view(-1, 3).index_add_(0, flat, value)
    film.weight.view(-1).index_add_(0, flat, weight)
    return film


def develop(film: Film, splat_scale=None) -> Tensor:
    """Resolve to linear HDR RGB."""
    w = film.weight.clamp_min(1e-8)[..., None]
    img = film.rgb / w
    if splat_scale is None:
        splat_scale = 1.0 / max(film.n_passes, 1.0)
    return img + film.splat * splat_scale
