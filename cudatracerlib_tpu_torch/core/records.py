"""Sampling-record constants (port of ``cudatracerlib_tpu/core/records.py``).

The record NamedTuples of the JAX module are not ported: the slice's BSDF
sampler returns its own ``SampleOut``.
"""
from __future__ import annotations

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

