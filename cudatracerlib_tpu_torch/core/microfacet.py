"""Microfacet normal distributions: Beckmann / GGX / Phong.

Port of ``cudatracerlib_tpu/core/microfacet.py``. All directions are in the
local shading frame (+z = normal). The distribution type is a per-lane int
tensor, so material batches with mixed NDFs evaluate branchlessly: all three
closed forms are computed and selected.

type codes: 0 = Beckmann, 1 = GGX, 2 = Phong.
"""
from __future__ import annotations

import math

import torch

from . import frame as fr
from . import vecmath as vm

Tensor = torch.Tensor

BECKMANN, GGX, PHONG = 0, 1, 2
_INV_PI = 1.0 / math.pi


def _phong_exponent(alpha):
    """Equivalent Phong exponent for Beckmann roughness alpha (Mitsuba mapping)."""
    return (2.0 / (alpha * alpha).clamp_min(1e-8) - 2.0).clamp_min(0.0)


def eval_d(dist: Tensor, alpha_x: Tensor, alpha_y: Tensor, m: Tensor) -> Tensor:
    """Microfacet density D(m), zero in the lower hemisphere."""
    ct = fr.cos_theta(m)
    ct2 = ct * ct
    valid = ct > 0.0
    ct2s = ct2.clamp_min(1e-12)
    ax2 = (alpha_x * alpha_x).clamp_min(1e-12)
    ay2 = (alpha_y * alpha_y).clamp_min(1e-12)
    # slope-space squared tangent, anisotropic
    e = (m[..., 0] ** 2 / ax2 + m[..., 1] ** 2 / ay2) / ct2s
    inv_norm = _INV_PI / torch.sqrt(ax2 * ay2)

    d_beck = inv_norm * torch.exp(-e) / (ct2 * ct2).clamp_min(1e-16)
    root = ct2 * (1.0 + e)
    d_ggx = inv_norm / (root * root).clamp_min(1e-16)
    expo = _phong_exponent(alpha_x)
    d_phong = (expo + 2.0) * (0.5 * _INV_PI) * torch.pow(ct.clamp_min(1e-12), expo)

    d = torch.where(dist == GGX, d_ggx, torch.where(dist == PHONG, d_phong, d_beck))
    return torch.where(valid, d, 0.0)


def _project_roughness(alpha_x, alpha_y, v):
    """Roughness projected onto the incidence plane of v."""
    inv_st2 = 1.0 / fr.sin_theta2(v).clamp_min(1e-12)
    iso = (alpha_x - alpha_y).abs() < 1e-7
    cos_phi2 = v[..., 0] ** 2 * inv_st2
    sin_phi2 = v[..., 1] ** 2 * inv_st2
    proj = torch.sqrt(cos_phi2 * alpha_x ** 2 + sin_phi2 * alpha_y ** 2)
    return torch.where(iso | (fr.sin_theta2(v) <= 1e-12), alpha_x, proj)


def smith_g1(dist: Tensor, alpha_x: Tensor, alpha_y: Tensor, v: Tensor,
             m: Tensor) -> Tensor:
    """Smith shadowing-masking for one direction."""
    # Backfacing w.r.t. micronormal -> zero
    back = vm.dot(v, m) * fr.cos_theta(v) <= 0.0
    tt = fr.tan_theta(v).abs()
    perp = tt < 1e-12  # perpendicular incidence
    alpha = _project_roughness(alpha_x, alpha_y, v)
    # convert phong to equivalent beckmann roughness for G
    alpha_g = torch.where(dist == PHONG,
                          torch.sqrt(2.0 / (_phong_exponent(alpha) + 2.0)), alpha)

    a = 1.0 / (alpha_g * tt).clamp_min(1e-12)
    # Beckmann/Phong rational fit
    a2 = a * a
    g_beck = torch.where(a >= 1.6, 1.0,
                         (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2))
    # GGX closed form
    root = alpha_g * tt
    g_ggx = 2.0 / (1.0 + torch.sqrt(1.0 + root * root))

    g = torch.where(dist == GGX, g_ggx, g_beck)
    return torch.where(back, 0.0, torch.where(perp, 1.0, g))


def smith_g(dist, alpha_x, alpha_y, wi, wo, m):
    return (smith_g1(dist, alpha_x, alpha_y, wi, m)
            * smith_g1(dist, alpha_x, alpha_y, wo, m))


def _sample_all(dist, alpha_x, alpha_y, u: Tensor):
    """Sample m ~ D(m) cos(theta). Returns (m, pdf)."""
    u0 = u[..., 0].clamp(1e-7, 1.0 - 1e-7)
    u1 = u[..., 1]
    iso = (alpha_x - alpha_y).abs() < 1e-7

    # azimuth (anisotropic correction per PBRT)
    phi_iso = 2.0 * math.pi * u1
    phi_aniso = torch.atan(alpha_y / alpha_x.clamp_min(1e-12)
                           * torch.tan(2.0 * math.pi * u1 + 0.5 * math.pi))
    phi_aniso = phi_aniso + torch.where(u1 > 0.5, math.pi, 0.0)
    phi = torch.where(iso, phi_iso, phi_aniso)
    cp, sp = torch.cos(phi), torch.sin(phi)
    denom = (cp ** 2 / (alpha_x ** 2).clamp_min(1e-12)
             + sp ** 2 / (alpha_y ** 2).clamp_min(1e-12))

    t2_beck = -torch.log(1.0 - u0) / denom.clamp_min(1e-12)
    t2_ggx = u0 / ((1.0 - u0) * denom).clamp_min(1e-12)
    expo = _phong_exponent(alpha_x)
    ct_phong = torch.pow(u0, 1.0 / (expo + 2.0))
    t2_phong = (1.0 - ct_phong ** 2).clamp_min(0.0) / (ct_phong ** 2).clamp_min(1e-12)

    tan2t = torch.where(dist == GGX, t2_ggx, torch.where(dist == PHONG, t2_phong, t2_beck))
    ct = 1.0 / torch.sqrt(1.0 + tan2t)
    st = torch.sqrt((1.0 - ct * ct).clamp_min(0.0))
    m = torch.stack([st * cp, st * sp, ct], dim=-1)
    pdf = eval_d(dist, alpha_x, alpha_y, m) * ct
    return m, pdf


def _sample_ggx_visible(wi: Tensor, alpha_x, alpha_y, u: Tensor):
    """Heitz 2018 VNDF sampling for GGX. wi must be in the upper hemisphere."""
    # stretch view direction
    v = vm.normalize(torch.stack([alpha_x * wi[..., 0], alpha_y * wi[..., 1],
                                  wi[..., 2]], dim=-1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = torch.rsqrt(lensq.clamp_min(1e-20))
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=v.device)
    t1 = torch.where((lensq > 1e-12)[..., None],
                     torch.stack([-v[..., 1] * inv, v[..., 0] * inv,
                                  torch.zeros_like(inv)], dim=-1),
                     ex.expand(v.shape))
    t2 = vm.cross(v, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt((1.0 - p1 * p1).clamp_min(0.0)) + s * p2
    nh = (p1[..., None] * t1 + p2[..., None] * t2
          + torch.sqrt((1.0 - p1 * p1 - p2 * p2).clamp_min(0.0))[..., None] * v)
    return vm.normalize(torch.stack([alpha_x * nh[..., 0], alpha_y * nh[..., 1],
                                     nh[..., 2].clamp_min(1e-6)], dim=-1))


def pdf_visible(dist, alpha_x, alpha_y, wi, m):
    """pdf of visible-normal sampling: G1(wi) |wi.m| D(m) / |cos(wi)|."""
    ci = fr.cos_theta(wi).abs()
    return (smith_g1(dist, alpha_x, alpha_y, wi, m) * vm.dot(wi, m).abs()
            * eval_d(dist, alpha_x, alpha_y, m) / ci.clamp_min(1e-12))


def sample(dist: Tensor, alpha_x: Tensor, alpha_y: Tensor, wi: Tensor, u: Tensor,
           sample_visible: bool = True):
    """Sample a micronormal. Returns (m, pdf).

    When sample_visible, GGX lanes use Heitz VNDF (wi flipped into the upper
    hemisphere internally); Beckmann/Phong lanes fall back to D*cos sampling.
    """
    m_all, pdf_all = _sample_all(dist, alpha_x, alpha_y, u)
    if not sample_visible:
        return m_all, pdf_all
    flip = fr.cos_theta(wi) < 0.0
    wi_up = torch.where(flip[..., None], -wi, wi)
    m_vis = _sample_ggx_visible(wi_up, alpha_x, alpha_y, u)
    pdf_vis = pdf_visible(dist, alpha_x, alpha_y, wi_up, m_vis)
    use_vis = dist == GGX
    m = torch.where(use_vis[..., None], m_vis, m_all)
    pdf_ = torch.where(use_vis, pdf_vis, pdf_all)
    return m, pdf_


def pdf(dist, alpha_x, alpha_y, wi, m, sample_visible: bool = True):
    pdf_all = eval_d(dist, alpha_x, alpha_y, m) * fr.cos_theta(m).abs()
    if not sample_visible:
        return pdf_all
    flip = fr.cos_theta(wi) < 0.0
    wi_up = torch.where(flip[..., None], -wi, wi)
    p_vis = pdf_visible(dist, alpha_x, alpha_y, wi_up, m)
    return torch.where(dist == GGX, p_vis, pdf_all)
