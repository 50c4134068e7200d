"""Sampling records (port of ``cudatracerlib_tpu/core/records.py``;
reference: ``SceneTypes/Samples.h:94-182``).

NamedTuples of batched tensors, the counterparts of Mitsuba's
sampling-record structs; `measure` uses the constants below. (The BSDF
sampler returns its own ``bsdf.SampleOut``, as the JAX package's does.)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

# Measures (EMeasure)
M_SOLID_ANGLE = 0
M_AREA = 1
M_DISCRETE = 2

# BSDF type flags (subset of Mitsuba's EBSDFType, used for strategy masking)
T_DIFFUSE_REFLECTION = 1 << 0
T_DIFFUSE_TRANSMISSION = 1 << 1
T_GLOSSY_REFLECTION = 1 << 2
T_GLOSSY_TRANSMISSION = 1 << 3
T_DELTA_REFLECTION = 1 << 4
T_DELTA_TRANSMISSION = 1 << 5
T_NULL = 1 << 6
T_SMOOTH = T_DIFFUSE_REFLECTION | T_DIFFUSE_TRANSMISSION | T_GLOSSY_REFLECTION | T_GLOSSY_TRANSMISSION
T_DELTA = T_DELTA_REFLECTION | T_DELTA_TRANSMISSION
T_ALL = T_SMOOTH | T_DELTA



class PositionSample(NamedTuple):
    p: Tensor       # (..., 3) sampled position
    n: Tensor       # (..., 3) surface normal at p (zeros if none)
    uv: Tensor      # (..., 2)
    pdf: Tensor     # (...,) pdf w.r.t. `measure`
    measure: Tensor  # (...,) int32


class DirectionSample(NamedTuple):
    d: Tensor
    pdf: Tensor
    measure: Tensor


class DirectSample(NamedTuple):
    """Sampling a point on an emitter/sensor as seen from a reference point."""
    p: Tensor        # (..., 3) point on the emitter
    n: Tensor        # (..., 3) normal at p
    d: Tensor        # (..., 3) unit direction ref -> p
    dist: Tensor     # (...,)
    pdf: Tensor      # (...,) pdf w.r.t. solid angle at the reference point
    measure: Tensor  # int32
    uv: Tensor       # (..., 2) position on the sensor film (for sensor sampling)


class BSDFSample(NamedTuple):
    wo: Tensor            # (..., 3) sampled direction, local frame
    weight: Tensor        # (..., 3) f * cos / pdf
    pdf: Tensor           # (...,)
    sampled_type: Tensor  # (...,) int32 bitmask
    eta: Tensor           # (...,) relative IOR change along the sampled direction


class PhaseSample(NamedTuple):
    wo: Tensor      # (..., 3) world frame
    weight: Tensor  # (...,) phase value / pdf (==1 for exact sampling)
    pdf: Tensor
