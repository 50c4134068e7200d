"""Ray and hit records for the traversal kernels.

Port of the records of ``cudatracerlib_tpu/ops/traversal.py``. The binary
BVH traversal of that module is not ported: every traversal of the port
goes through the 8-wide fat-row table (``ops/traversal8.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Rays(NamedTuple):
    o: Tensor      # (B, 3)
    d: Tensor      # (B, 3)
    tmin: Tensor   # (B,)
    tmax: Tensor   # (B,)


class Hit(NamedTuple):
    t: Tensor       # (B,) hit distance (tmax if miss)
    tri: Tensor     # (B,) int32 triangle id, -1 if miss
    u: Tensor       # (B,) barycentric
    v: Tensor       # (B,)
    inst: "Tensor | None" = None  # (B,) i32 instance id of two-level scenes

    @property
    def valid(self) -> Tensor:
        return self.tri >= 0


def _safe_inv(d: Tensor) -> Tensor:
    eps = 1e-20
    safe_d = torch.where(d.abs() < eps, torch.where(d >= 0, eps, -eps), d)
    return 1.0 / safe_d
