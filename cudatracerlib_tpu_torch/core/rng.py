"""Counter-based vectorized RNG for the render loops.

Port of ``cudatracerlib_tpu/core/rng.py``: the PCG-RXS-M-XS hash of
Jarzynski & Olano, seeded from (pixel_id, sample_id, pass_id). The streams
match the JAX package bit for bit.

PyTorch lacks most uint32 arithmetic (no ``>>`` on ``torch.uint32`` on the
CPU), so a uint32 lives in an int64 tensor masked with 0xFFFFFFFF. Every
product of two such values below stays under 2^62, so int64 never wraps.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF


def _u32(x):
    if isinstance(x, int):
        return x & M32
    return x.to(torch.int64) & M32


def pcg_hash(x):
    """One round of PCG-RXS-M-XS on a uint32 (held in int64)."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def hash_combine(*xs):
    h = 0x9E3779B9
    for x in xs:
        h = pcg_hash(h ^ _u32(x))
    return h


def seed(pixel_id: Tensor, sample_id, pass_id=0) -> Tensor:
    """Per-lane RNG state from identifying integers."""
    return hash_combine(pixel_id, sample_id, pass_id)


def next_uint(state: Tensor):
    """Advance state, return (new_state, uniform uint32), both int64."""
    new_state = (state * 747796405 + 2891336453) & M32
    word = (((new_state >> ((new_state >> 28) + 4)) ^ new_state)
            * 277803737) & M32
    return new_state, (word >> 22) ^ word


def next_float(state: Tensor):
    """Uniform float32 in [0, 1)."""
    state, u = next_uint(state)
    return state, (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def next_float2(state: Tensor):
    state, a = next_float(state)
    state, b = next_float(state)
    return state, torch.stack([a, b], dim=-1)


def next_float3(state: Tensor):
    state, a = next_float(state)
    state, b = next_float(state)
    state, c = next_float(state)
    return state, torch.stack([a, b, c], dim=-1)
