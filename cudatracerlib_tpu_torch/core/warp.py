"""Sampling warps: [0,1)^2 -> distributions on spheres/disks/triangles.

Port of ``cudatracerlib_tpu/core/warp.py``. All functions are batched over
leading dims; ``u`` is a ``(..., 2)`` tensor of uniforms.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor
INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(u: Tensor) -> Tensor:
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf() -> float:
    return INV_FOURPI


def square_to_uniform_hemisphere(u: Tensor) -> Tensor:
    z = u[..., 0]
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf() -> float:
    return INV_TWOPI


def square_to_cosine_hemisphere(u: Tensor) -> Tensor:
    p = square_to_uniform_disk_concentric(u)
    z = torch.sqrt((1.0 - p[..., 0] ** 2 - p[..., 1] ** 2).clamp_min(1e-12))
    return torch.cat([p, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(d: Tensor) -> Tensor:
    return d[..., 2].clamp_min(0.0) * INV_PI


def square_to_uniform_cone(u: Tensor, cos_cutoff) -> Tensor:
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_cutoff
    sin_theta = torch.sqrt((1.0 - cos_theta * cos_theta).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def square_to_uniform_cone_pdf(cos_cutoff: Tensor) -> Tensor:
    return INV_TWOPI / (1.0 - cos_cutoff).clamp_min(1e-12)


def square_to_uniform_disk(u: Tensor) -> Tensor:
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_concentric(u: Tensor) -> Tensor:
    """Shirley-Chiu concentric disk mapping (lower distortion than polar)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)

    def safe(a, b):
        return a / torch.where(b.abs() < 1e-12,
                               torch.where(b >= 0, 1e-12, -1e-12), b)

    theta = torch.where(use_x, (math.pi / 4.0) * safe(oy, ox),
                        (math.pi / 2.0) - (math.pi / 4.0) * safe(ox, oy))
    zero = (ox.abs() < 1e-12) & (oy.abs() < 1e-12)
    x = torch.where(zero, 0.0, r * torch.cos(theta))
    y = torch.where(zero, 0.0, r * torch.sin(theta))
    return torch.stack([x, y], dim=-1)


def square_to_uniform_disk_pdf() -> float:
    return INV_PI


def square_to_uniform_triangle(u: Tensor) -> Tensor:
    """Barycentric (b0, b1) uniform over the unit triangle."""
    a = torch.sqrt(u[..., 0].clamp_min(0.0))
    return torch.stack([1.0 - a, a * u[..., 1]], dim=-1)


def square_to_std_normal(u: Tensor) -> Tensor:
    r = torch.sqrt(-2.0 * torch.log((1.0 - u[..., 0]).clamp_min(1e-12)))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def interval_to_tent(u: Tensor) -> Tensor:
    """[0,1) -> [-1,1] with tent density."""
    sign = torch.where(u < 0.5, 1.0, -1.0)
    t = torch.where(u < 0.5, 2.0 * u, 2.0 * (1.0 - u))
    return sign * (1.0 - torch.sqrt(t.clamp_min(0.0)))


def square_to_tent(u: Tensor) -> Tensor:
    return torch.stack([interval_to_tent(u[..., 0]), interval_to_tent(u[..., 1])],
                       dim=-1)
