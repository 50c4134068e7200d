"""Axis-aligned bounding boxes (reference: ``Math/AABB.h``).

Port of ``cudatracerlib_tpu/core/aabb.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class AABB(NamedTuple):
    lo: Tensor  # (..., 3)
    hi: Tensor  # (..., 3)

    @staticmethod
    def empty(shape=(), device="cpu") -> "AABB":
        return AABB(torch.full(shape + (3,), float("inf"), device=device),
                    torch.full(shape + (3,), float("-inf"), device=device))

    def union(self, other: "AABB") -> "AABB":
        return AABB(torch.minimum(self.lo, other.lo), torch.maximum(self.hi, other.hi))

    def extend(self, p: Tensor) -> "AABB":
        return AABB(torch.minimum(self.lo, p), torch.maximum(self.hi, p))

    def center(self) -> Tensor:
        return 0.5 * (self.lo + self.hi)

    def extents(self) -> Tensor:
        return self.hi - self.lo

    def surface_area(self) -> Tensor:
        d = (self.hi - self.lo).clamp_min(0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])

    def contains(self, p: Tensor) -> Tensor:
        return torch.all((p >= self.lo) & (p <= self.hi), dim=-1)

    def radius(self) -> Tensor:
        return 0.5 * torch.sqrt(torch.sum(self.extents() ** 2, dim=-1))


def ray_aabb(lo: Tensor, hi: Tensor, o: Tensor, inv_d: Tensor, t_min, t_max):
    """Slab test. Returns (hit_mask, t_near). Shapes broadcast; inv_d = 1/d."""
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t_near = torch.maximum(tn.amax(dim=-1), torch.as_tensor(t_min, dtype=tn.dtype,
                                                            device=tn.device))
    t_far = torch.minimum(tf.amin(dim=-1), torch.as_tensor(t_max, dtype=tf.dtype,
                                                           device=tf.device))
    return t_near <= t_far, t_near
