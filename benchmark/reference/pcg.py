"""PCG-RXS-M-XS hashing and stepping on uint32 values held in int64, the
sample streams the game frame draws (seeded by pixel, sample and pass)."""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _u32(x):
    return x & M32 if isinstance(x, int) else x.to(torch.int64) & M32


def pcg_hash(x):
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    return (word >> 22) ^ word


def seed(pixel, sample, pass_idx):
    h = 0x9E3779B9
    for x in (pixel, sample, pass_idx):
        h = pcg_hash(h ^ _u32(x))
    return h


def next_float(state):
    """(new state, uniform float32 in [0, 1) with 24 random bits)."""
    state = (state * 747796405 + 2891336453) & M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & M32
    u = (word >> 22) ^ word
    return state, (u >> 8).to(torch.float32) * (1.0 / (1 << 24))
