"""Vector math over float32 tensors with trailing dim 3.

Port of ``cudatracerlib_tpu/core/vecmath.py``. Dot and cross products are
written out component by component, so they round the same way on the CPU
and on a CUDA device. The 4x4 helpers build float32 (4, 4) tensors;
``transform_point`` and ``transform_vector`` take one (4, 4) matrix.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

EPS = 1e-6
INF = math.inf


def vec3(x, y, z, dtype=torch.float32) -> Tensor:
    return torch.stack(torch.broadcast_tensors(
        torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype),
        torch.as_tensor(z, dtype=dtype)), dim=-1)

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


def distance(a: Tensor, b: Tensor) -> Tensor:
    return length(a - b)


def distance_sqr(a: Tensor, b: Tensor) -> Tensor:
    return length_sqr(a - b)


def normalize(a: Tensor) -> Tensor:
    return a * torch.rsqrt(length_sqr(a).clamp_min(1e-30))[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


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


def spherical_direction(sin_theta, cos_theta, phi) -> Tensor:
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                        cos_theta], dim=-1)


def spherical_theta(v: Tensor) -> Tensor:
    return torch.arccos(v[..., 2].clamp(-1.0, 1.0))


def spherical_phi(v: Tensor) -> Tensor:
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def select(mask: Tensor, a, b):
    """Broadcasting where() that adds trailing dims of `a` to `mask` as needed."""
    extra = a.ndim - mask.ndim if hasattr(a, "ndim") else 0
    m = mask.reshape(mask.shape + (1,) * extra) if extra > 0 else mask
    return torch.where(m, a, b)


# ---------------------------------------------------------------------------
# 4x4 affine transforms (float4x4, Math/float4x4.h). Stored row-major (4,4).
# ---------------------------------------------------------------------------

def _f32(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def mat4_identity() -> Tensor:
    return torch.eye(4, dtype=torch.float32)


def mat4_translate(t) -> Tensor:
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 3] = _f32(t)
    return m


def mat4_scale(s) -> Tensor:
    s = torch.broadcast_to(_f32(s), (3,))
    return torch.diag(torch.cat([s, torch.ones(1, dtype=torch.float32)]))


def mat4_rotate(axis, angle_rad) -> Tensor:
    axis = _f32(axis)
    axis = axis / torch.linalg.norm(axis)
    x, y, z = axis
    a = _f32(angle_rad)
    c, s = torch.cos(a), torch.sin(a)
    C = 1 - c
    zero, one = torch.zeros(()), torch.ones(())
    return torch.stack([
        torch.stack([x * x * C + c, x * y * C - z * s, x * z * C + y * s, zero]),
        torch.stack([y * x * C + z * s, y * y * C + c, y * z * C - x * s, zero]),
        torch.stack([z * x * C - y * s, z * y * C + x * s, z * z * C + c, zero]),
        torch.stack([zero, zero, zero, one])])


def mat4_mul(a: Tensor, b: Tensor) -> Tensor:
    return a @ b


def mat4_inverse(m: Tensor) -> Tensor:
    return torch.linalg.inv(m)


def transform_normal(m_inv: Tensor, n: Tensor) -> Tensor:
    """Transform a normal with the *inverse* (4,4) matrix (its 3x3 transposed)."""
    return torch.stack([dot(m_inv[:3, i], n) for i in range(3)], dim=-1)


def look_at(origin, target, up) -> Tensor:
    """Camera-to-world matrix: +z forward, +y up, +x right (Mitsuba convention)."""
    origin, target, up = _f32(origin), _f32(target), _f32(up)
    d = target - origin
    d = d / torch.linalg.norm(d)
    r = cross(up / torch.linalg.norm(up), d)
    r = r / torch.linalg.norm(r)
    u = cross(d, r)
    m = torch.stack([r, u, d, origin], dim=-1)  # columns
    return torch.cat([m, _f32([[0., 0., 0., 1.]])], dim=0)
