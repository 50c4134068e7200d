"""RGB spectrum helpers.

Port of the sRGB transfer functions of ``cudatracerlib_tpu/core/spectrum.py``
(a spectrum is a plain ``(..., 3)`` float32 tensor in linear RGB). The rest
of that module (XYZ, RGBE, spectral transport) is not ported yet.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow(((c + 0.055) / 1.055).clamp_min(0.0), 2.4))


def linear_to_srgb(c: Tensor) -> Tensor:
    c = c.clamp_min(0.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
