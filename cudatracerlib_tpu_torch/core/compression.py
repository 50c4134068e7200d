"""Bit-packing of normals and UVs for compact triangle shading data.

Port of ``cudatracerlib_tpu/core/compression.py``. Reference:
``Math/Compression.h`` (normal <-> uint16 spherical encoding) and
``Math/half.h`` (half floats; here ``torch.float16``). The packing runs in
int32 and only the result is uint16.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def normal_to_uint16(n: Tensor) -> Tensor:
    """Spherical encode: 8 bits theta, 8 bits phi."""
    theta = torch.arccos(n[..., 2].clamp(-1.0, 1.0))   # [0, pi]
    phi = torch.atan2(n[..., 1], n[..., 0])             # [-pi, pi]
    phi = torch.where(phi < 0, phi + 2.0 * math.pi, phi)
    qt = torch.round(theta / math.pi * 255.0).clamp(0, 255).to(torch.int32)
    qp = torch.round(phi / (2.0 * math.pi) * 255.0).clamp(0, 255).to(torch.int32)
    return (qt | (qp << 8)).to(torch.uint16)


def uint16_to_normal(p: Tensor) -> Tensor:
    p = p.to(torch.int32)
    theta = (p & 0xFF).to(torch.float32) / 255.0 * math.pi
    phi = ((p >> 8) & 0xFF).to(torch.float32) / 255.0 * (2.0 * math.pi)
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)


def f32_to_half(x: Tensor) -> Tensor:
    return x.to(torch.float16)


def half_to_f32(x: Tensor) -> Tensor:
    return x.to(torch.float32)


def uv_to_half2(uv: Tensor) -> Tensor:
    return uv.to(torch.float16)
