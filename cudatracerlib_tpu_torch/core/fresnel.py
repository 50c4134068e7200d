"""Fresnel equations (port of ``cudatracerlib_tpu/core/fresnel.py``).

Mitsuba conventions: ``fresnel_dielectric_ext(cos_theta_i, eta)`` returns both the
reflectance and the signed transmitted cosine; ``eta = int_ior / ext_ior``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _f32(x, like: Tensor) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def fresnel_dielectric_ext(cos_theta_i: Tensor, eta):
    """Unpolarized Fresnel reflectance at a dielectric boundary.

    Returns (F, cos_theta_t). cos_theta_t has the opposite sign of cos_theta_i
    (it is the cosine of the *transmitted* direction w.r.t. the normal).
    Handles rays arriving from either side (cos_theta_i may be negative).
    """
    eta = _f32(eta, cos_theta_i)
    # Snell: sin_t^2 = sin_i^2 / eta_rel^2 where eta_rel flips with the side
    scale = torch.where(cos_theta_i > 0, 1.0 / eta, eta)
    cos_theta_t_sqr = 1.0 - (1.0 - cos_theta_i * cos_theta_i) * (scale * scale)
    tir = cos_theta_t_sqr <= 0.0

    abs_ci = cos_theta_i.abs()
    abs_ct = torch.sqrt(cos_theta_t_sqr.clamp_min(0.0))

    eta_it = torch.where(cos_theta_i > 0, eta, 1.0 / eta)
    rs = (abs_ci - eta_it * abs_ct) / (abs_ci + eta_it * abs_ct).clamp_min(1e-12)
    rp = (eta_it * abs_ci - abs_ct) / (eta_it * abs_ci + abs_ct).clamp_min(1e-12)
    F = 0.5 * (rs * rs + rp * rp)
    F = torch.where(tir, 1.0, F)
    cos_theta_t = torch.where(tir, 0.0, torch.where(cos_theta_i > 0, -abs_ct, abs_ct))
    # Degenerate eta == 1 -> no reflection
    same = (eta - 1.0).abs() < 1e-6
    F = torch.where(same, 0.0, F)
    cos_theta_t = torch.where(same, -cos_theta_i, cos_theta_t)
    return F, cos_theta_t


def fresnel_dielectric(cos_theta_i: Tensor, eta) -> Tensor:
    F, _ = fresnel_dielectric_ext(cos_theta_i, eta)
    return F


def fresnel_conductor_exact(cos_theta_i: Tensor, eta: Tensor, k: Tensor) -> Tensor:
    """Exact unpolarized conductor Fresnel (Mitsuba fresnelConductorExact).

    eta, k are (...,3) spectral; cos_theta_i (...,). Returns (...,3).
    """
    ci = cos_theta_i.abs()[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2pb2 = torch.sqrt((t0 * t0 + 4.0 * k2 * eta2).clamp_min(0.0))
    t1 = a2pb2 + ci2
    a = torch.sqrt((0.5 * (a2pb2 + t0)).clamp_min(0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / (t1 + t2).clamp_min(1e-12)
    t3 = ci2 * a2pb2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / (t3 + t4).clamp_min(1e-12)
    return 0.5 * (rp + rs)


def fresnel_diffuse_reflectance(eta) -> Tensor:
    """Average diffuse Fresnel reflectance (Mitsuba fresnelDiffuseReflectance,
    fast polynomial fit). Used by plastic/coating internal scattering."""
    eta = torch.as_tensor(eta, dtype=torch.float32)

    # d'Eon & Irving fit, valid for eta in [1, 3]
    def fit_gt1(e):
        ie = 1.0 / e
        return (0.919317 - 3.4793 * ie + 6.75335 * ie ** 2
                - 7.80989 * ie ** 3 + 4.98554 * ie ** 4 - 1.36881 * ie ** 5)

    def fit_lt1(e):
        return (0.828421 - 2.62051 * e + 3.362 * e ** 2
                - 1.95284 * e ** 3 + 0.236494 * e ** 4 + 0.145787 * e ** 5)

    return torch.where(eta < 1.0, fit_lt1(eta), fit_gt1(eta))
