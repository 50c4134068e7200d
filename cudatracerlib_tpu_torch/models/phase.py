"""Phase functions: HG, isotropic, Kajiya-Kay, Rayleigh.

Port of ``cudatracerlib_tpu/models/phase.py``. Batched, branchless
dispatch on per-lane type ids: 0 = HG, 1 = isotropic, 2 = Kajiya-Kay,
3 = Rayleigh. wi_prop is the incoming propagation direction and wo the
outgoing one, so cos_theta = dot(wi_prop, wo) and HG's mean cosine is +g.
"""
from __future__ import annotations

import math

import torch

from ..core import frame as fr
from ..core import vecmath as vm

Tensor = torch.Tensor

PH_HG, PH_ISOTROPIC, PH_KAJIYAKAY, PH_RAYLEIGH = 0, 1, 2, 3
INV_FOURPI = 1.0 / (4.0 * math.pi)
# Kajiya-Kay constants (the reference's defaults)
KK_KS, KK_KD, KK_EXPONENT = 0.4, 0.2, 4.0


def _hg(cos_t, g):
    """HG with cos_t = dot(propagation_in, w_out): mean cosine = +g (forward)."""
    g2 = g * g
    denom = (1.0 + g2 - 2.0 * g * cos_t).clamp_min(1e-8)
    return INV_FOURPI * (1.0 - g2) / (denom * torch.sqrt(denom))


def _rayleigh(cos_t):
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_t * cos_t)


def _kajiya_kay(cos_t):
    """A cos^e lobe about the propagation direction plus an isotropic kd
    floor, each term integrating to its k over the sphere."""
    spec_norm = (KK_EXPONENT + 1.0) / (2.0 * math.pi)
    spec = cos_t.clamp_min(0.0) ** KK_EXPONENT * spec_norm
    return KK_KD * INV_FOURPI + KK_KS * spec


def eval_phase(ptype: Tensor, g: Tensor, wi_prop: Tensor, wo: Tensor) -> Tensor:
    """p(wi->wo); wi_prop is the incoming propagation direction."""
    cos_t = vm.dot(wi_prop, wo)
    p_iso = torch.full_like(cos_t, INV_FOURPI)
    return torch.where(ptype == PH_HG, _hg(cos_t, g),
                       torch.where(ptype == PH_RAYLEIGH, _rayleigh(cos_t),
                                   torch.where(ptype == PH_KAJIYAKAY,
                                               _kajiya_kay(cos_t), p_iso)))


def pdf_phase(ptype, g, wi_prop, wo) -> Tensor:
    """HG and isotropic sample exactly; Rayleigh and Kajiya-Kay are sampled
    isotropically, so their pdf is the uniform one."""
    cos_t = vm.dot(wi_prop, wo)
    return torch.where(ptype == PH_HG, _hg(cos_t, g),
                       torch.full_like(cos_t, INV_FOURPI))


def sample_phase(ptype: Tensor, g: Tensor, wi_prop: Tensor, u: Tensor):
    """Sample wo. Returns (wo, weight, pdf) with weight = p/pdf."""
    g_safe = torch.where(g.abs() < 1e-3, 1e-3, g)
    sqr = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u[..., 0])
    cos_hg = (1.0 + g_safe * g_safe - sqr * sqr) / (2.0 * g_safe)
    cos_iso = 1.0 - 2.0 * u[..., 0]
    cos_t = torch.where((ptype == PH_HG) & (g.abs() >= 1e-3), cos_hg, cos_iso)
    cos_t = cos_t.clamp(-1.0, 1.0)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    phi = 2.0 * math.pi * u[..., 1]
    frame = fr.Frame.from_normal(wi_prop)
    wo = frame.to_world(torch.stack([sin_t * torch.cos(phi),
                                     sin_t * torch.sin(phi), cos_t], -1))
    pdf = pdf_phase(ptype, g, wi_prop, wo)
    p = eval_phase(ptype, g, wi_prop, wo)
    weight = p / pdf.clamp_min(1e-12)
    return wo, weight, pdf
