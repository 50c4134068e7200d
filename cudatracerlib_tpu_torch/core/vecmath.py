"""Vector math over float32 tensors with trailing dim 3.

Port of ``cudatracerlib_tpu/core/vecmath.py``. Dot and cross products are
written out component by component, so they round the same way on the CPU
and on a CUDA device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

def dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def absdot(a: Tensor, b: Tensor) -> Tensor:
    return dot(a, b).abs()


def cross(a: Tensor, b: Tensor) -> Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_sqr(a: Tensor) -> Tensor:
    return dot(a, a)


def length(a: Tensor) -> Tensor:
    return torch.sqrt(length_sqr(a))


def normalize(a: Tensor) -> Tensor:
    return a * torch.rsqrt(length_sqr(a).clamp_min(1e-30))[..., None]


def reflect(w: Tensor, n: Tensor) -> Tensor:
    """Reflect direction ``w`` (pointing away from surface) about normal ``n``."""
    return 2.0 * dot(w, n)[..., None] * n - w


def refract(w: Tensor, n: Tensor, eta: Tensor, cos_theta_t: Tensor) -> Tensor:
    """Refract direction ``w`` (pointing away from the surface) about ``n``.

    ``eta`` is the material's relative IOR (int/ext); ``cos_theta_t`` is the
    signed transmitted cosine from ``fresnel_dielectric_ext`` (opposite sign
    of ``dot(w, n)``): wo = -eta_r*w + (eta_r*dot(w,n) + cos_theta_t)*n with
    eta_r = eta_i/eta_t for this crossing."""
    eta_r = torch.where(cos_theta_t < 0, 1.0 / eta, eta)
    return n * (eta_r * dot(w, n) + cos_theta_t)[..., None] - w * eta_r[..., None]


def coordinate_system(n: Tensor):
    """Build an orthonormal basis around unit vector n (Duff et al. 2017 branchless)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    s = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return t, s


def transform_point(m: Tensor, p: Tensor) -> Tensor:
    """Apply a (4,4) affine matrix to (...,3) points."""
    return transform_vector(m, p) + m[:3, 3]


def transform_vector(m: Tensor, v: Tensor) -> Tensor:
    """Apply the 3x3 part of a (4,4) matrix to (...,3) vectors."""
    return torch.stack([dot(m[i, :3], v) for i in range(3)], dim=-1)
