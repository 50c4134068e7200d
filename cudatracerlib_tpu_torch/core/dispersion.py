"""Wavelength-dependent IOR models (reference: ``SceneTypes/Dispersion.h``:
Cauchy, Sellmeier, linear interpolation aggregates).

Port of ``cudatracerlib_tpu/core/dispersion.py``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

DISP_CAUCHY, DISP_SELLMEIER, DISP_LINEAR = 0, 1, 2

# representative wavelengths for RGB rendering (micrometers)
RGB_WAVELENGTHS_UM = torch.tensor([0.610, 0.550, 0.465], dtype=torch.float32)


def cauchy_ior(a: Tensor, b: Tensor, lam_um: Tensor) -> Tensor:
    """n(lambda) = A + B / lambda^2 (lambda in micrometers)."""
    return a + b / (lam_um * lam_um)


def sellmeier_ior(b_coeffs, c_coeffs, lam_um: Tensor) -> Tensor:
    """n^2(lambda) = 1 + sum_i B_i lam^2 / (lam^2 - C_i)."""
    l2 = lam_um * lam_um
    n2 = 1.0
    for bi, ci in zip(b_coeffs, c_coeffs):
        n2 = n2 + bi * l2 / (l2 - ci)
    return torch.sqrt(torch.as_tensor(n2).clamp_min(1.0))


def linear_ior(n_min, n_max, lam_um: Tensor, lam_min=0.38, lam_max=0.78) -> Tensor:
    t = ((lam_um - lam_min) / (lam_max - lam_min)).clamp(0.0, 1.0)
    return n_max + (n_min - n_max) * t  # shorter wavelengths bend more


def eval_ior(disp_type: Tensor, params: Tensor, lam_um: Tensor) -> Tensor:
    """Dispatch over dispersion models; params rows: [A/B0, B/B1, B2, C0, C1, C2]."""
    lam_um = torch.as_tensor(lam_um, dtype=params.dtype, device=params.device)
    cau = cauchy_ior(params[..., 0], params[..., 1], lam_um)
    sel = sellmeier_ior([params[..., 0], params[..., 1], params[..., 2]],
                        [params[..., 3], params[..., 4], params[..., 5]], lam_um)
    lin = linear_ior(params[..., 0], params[..., 1], lam_um)
    return torch.where(disp_type == DISP_CAUCHY, cau,
                       torch.where(disp_type == DISP_SELLMEIER, sel, lin))


def rgb_iors(disp_type: Tensor, params: Tensor) -> Tensor:
    """(..., 3) per-channel IOR at the RGB representative wavelengths."""
    return torch.stack([eval_ior(disp_type, params, RGB_WAVELENGTHS_UM[c])
                        for c in range(3)], dim=-1)
