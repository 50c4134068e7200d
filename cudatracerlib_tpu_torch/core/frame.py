"""Shading frames (port of ``cudatracerlib_tpu/core/frame.py``).

A Frame is a batched orthonormal basis stored as three ``(..., 3)`` tensors.
All BSDF math happens in the local frame where the normal is +z.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath as vm

Tensor = torch.Tensor


class Frame(NamedTuple):
    t: Tensor  # tangent    (..., 3)
    s: Tensor  # bitangent  (..., 3)
    n: Tensor  # normal     (..., 3)

    @staticmethod
    def from_normal(n: Tensor) -> "Frame":
        t, s = vm.coordinate_system(n)
        return Frame(t, s, n)

    @staticmethod
    def from_tn(t: Tensor, n: Tensor) -> "Frame":
        """Gram-Schmidt a tangent against the normal."""
        t = vm.normalize(t - n * vm.dot(t, n)[..., None])
        s = vm.cross(n, t)
        return Frame(t, s, n)

    def to_local(self, v: Tensor) -> Tensor:
        return torch.stack([vm.dot(v, self.t), vm.dot(v, self.s),
                            vm.dot(v, self.n)], dim=-1)

    def to_world(self, v: Tensor) -> Tensor:
        return self.t * v[..., 0:1] + self.s * v[..., 1:2] + self.n * v[..., 2:3]


def cos_theta(v: Tensor) -> Tensor:
    return v[..., 2]


def abs_cos_theta(v: Tensor) -> Tensor:
    return v[..., 2].abs()


def cos_theta2(v: Tensor) -> Tensor:
    return v[..., 2] * v[..., 2]


def sin_theta2(v: Tensor) -> Tensor:
    return (1.0 - cos_theta2(v)).clamp_min(0.0)


def sin_theta(v: Tensor) -> Tensor:
    return torch.sqrt(sin_theta2(v))


def tan_theta(v: Tensor) -> Tensor:
    return sin_theta(v) / torch.where(v[..., 2].abs() < 1e-12, 1e-12, v[..., 2])


def tan_theta2(v: Tensor) -> Tensor:
    c2 = cos_theta2(v)
    return (1.0 - c2).clamp_min(0.0) / c2.clamp_min(1e-20)


def sin_phi(v: Tensor) -> Tensor:
    st = sin_theta(v)
    return torch.where(st < 1e-12, 0.0,
                       (v[..., 1] / st.clamp_min(1e-12)).clamp(-1.0, 1.0))


def cos_phi(v: Tensor) -> Tensor:
    st = sin_theta(v)
    return torch.where(st < 1e-12, 1.0,
                       (v[..., 0] / st.clamp_min(1e-12)).clamp(-1.0, 1.0))



def same_hemisphere(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 2] * b[..., 2] > 0.0
