"""Sample-sequence generators: independent, stratified and Sobol'.

Port of ``cudatracerlib_tpu/models/samplers.py``. Every sampler is a
counter-based pure function of (pixel_id, sample_index, dimension):

- independent: the PCG hash stream (core/rng.py);
- stratified: jittered strata, hash-permuted per pixel, combined with a
  per-pixel rotation mod 1;
- sobol: 64 dimensions of a Sobol' sequence (Joe-Kuo initialisation for
  the first dimensions, programmatically derived primitive polynomials
  beyond), Owen-scrambled per (pixel, dimension) with the Laine-Karras
  hash (Burley 2020). Dimensions past the table draw independently.

The direction table is built in numpy exactly as the JAX package builds it.
uint32 values live in int64 tensors masked to 32 bits, as in core/rng.py.
The bounce loop is Python, so a dimension is a Python int and the
dimension-dependent choices are made on the host; a sample index that is a
Python int (one per pass, as the tracers pass it) has its unscrambled
Sobol' value computed on the host too, leaving one scramble per lane.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng as rngmod

Tensor = torch.Tensor
M32 = rngmod.M32

INDEPENDENT, STRATIFIED, SOBOL = 0, 1, 2

SOBOL_DIMS = 64          # PT draws dims 4+6d..9+6d; depth 9 tops out at 63
_SOBOL_DIRS = None


def _pmod(a: int, p: int) -> int:
    """a mod p over GF(2)[x] (ints as bit-packed polynomials)."""
    dp = p.bit_length() - 1
    while a.bit_length() - 1 >= dp and a:
        a ^= p << (a.bit_length() - 1 - dp)
    return a


def _pmul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        a <<= 1
        b >>= 1
    return r


def _ppowmod(base: int, e: int, p: int) -> int:
    r, base = 1, _pmod(base, p)
    while e:
        if e & 1:
            r = _pmod(_pmul(r, base), p)
        base = _pmod(_pmul(base, base), p)
        e >>= 1
    return r


def _prime_factors(n: int):
    fac, d = set(), 2
    while d * d <= n:
        while n % d == 0:
            fac.add(d)
            n //= d
        d += 1
    if n > 1:
        fac.add(n)
    return fac


def _primitive_polys(count: int):
    """First `count` primitive polynomials over GF(2), ordered by degree.

    p is primitive iff ord(x) = 2^s - 1 in GF(2)[x]/(p): x^(2^s-1) == 1 and
    x^((2^s-1)/q) != 1 for every prime q | 2^s-1. A reducible p cannot pass
    (its unit group is strictly smaller than 2^s - 1), so no separate
    irreducibility test is needed.
    """
    found, s = [], 1
    while len(found) < count:
        mers = (1 << s) - 1
        fac = _prime_factors(mers) if mers > 1 else set()
        for p in range((1 << s) | 1, 1 << (s + 1), 2):
            if _ppowmod(2, mers, p) != 1:
                continue
            if any(_ppowmod(2, mers // q, p) == 1 for q in fac):
                continue
            found.append((s, p))
            if len(found) >= count:
                break
        s += 1
    return found


def _sobol_directions(n_dims: int = SOBOL_DIMS) -> np.ndarray:
    """Direction-number matrices (n_dims, 32) uint32.

    Dims 1..7 use the published Joe-Kuo initial m values (good 2D
    projections); higher dims use the next primitive polynomials with
    deterministic odd initial m_i in [1, 2^i) — any such choice yields a
    valid (t,s)-sequence in base 2, and the per-dimension Owen scrambling
    supplies the projection decorrelation beyond that.
    """
    global _SOBOL_DIRS
    if _SOBOL_DIRS is not None and _SOBOL_DIRS.shape[0] >= n_dims:
        return _SOBOL_DIRS
    n_dims = max(n_dims, SOBOL_DIMS)
    # Joe & Kuo table head: encoded interior bits (a) + degree + initial m
    jk_polys = [0, 1, 1, 2, 1, 4, 2]
    jk_degs = [1, 2, 3, 3, 4, 4, 5]
    jk_m = [[1], [1, 3], [1, 3, 1], [1, 1, 1], [1, 1, 3, 3],
            [1, 3, 5, 13], [1, 1, 5, 5, 17]]
    prims = _primitive_polys(n_dims - 1)
    rng = np.random.default_rng(20260819)
    degs, polys, m_inits = [], [], []
    for d in range(n_dims - 1):
        if d < len(jk_degs):
            degs.append(jk_degs[d])
            polys.append(jk_polys[d])
            m_inits.append(list(jk_m[d]))
        else:
            s, p = prims[d]
            degs.append(s)
            polys.append((p >> 1) & ((1 << (s - 1)) - 1))
            m_inits.append([int(rng.integers(0, 1 << i)) * 2 + 1
                            for i in range(s)])
    dirs = np.zeros((n_dims, 32), np.uint32)
    for i in range(32):
        dirs[0, i] = np.uint32(1) << np.uint32(31 - i)
    for d in range(1, n_dims):
        s, a, m = degs[d - 1], polys[d - 1], list(m_inits[d - 1])
        for i in range(s, 32):
            val = m[i - s]
            val ^= (m[i - s] << s)
            for k in range(1, s):
                if (a >> (s - 1 - k)) & 1:
                    val ^= m[i - k] << k
            m.append(val)
        for i in range(32):
            dirs[d, i] = np.uint32(m[i]) << np.uint32(31 - i)
    _SOBOL_DIRS = dirs
    return dirs


def _reverse_bits32(x: Tensor) -> Tensor:
    x = ((x >> 16) | (x << 16)) & M32
    x = ((x & 0x00ff00ff) << 8) | ((x >> 8) & 0x00ff00ff)
    x = ((x & 0x0f0f0f0f) << 4) | ((x >> 4) & 0x0f0f0f0f)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2^32 of a uint32 x (in int64) and a uint32 constant. The
    whole product can pass 2^63, so the constant is split into 16-bit
    halves: each partial product stays under 2^48 and int64 never wraps."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _laine_karras(x: Tensor, seed: Tensor) -> Tensor:
    """Laine-Karras hash: a random base-2 nested uniform permutation of the
    bits of x (acts on the reversed bit order), keyed by seed. Constants from
    Burley, "Practical Hash-based Owen Scrambling" (JCGT 2020)."""
    x = (x + seed) & M32
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def owen_scramble(x: Tensor, seed: Tensor) -> Tensor:
    """Hash-based Owen scramble of a 32-bit radical-inverse-oriented value."""
    return _reverse_bits32(_laine_karras(_reverse_bits32(rngmod._u32(x)),
                                         rngmod._u32(seed)))


def _sobol_bits(index, row) -> "Tensor | int":
    """The unscrambled Sobol' integer of `index` over the direction row:
    on the host for a Python int, per lane for a tensor."""
    if isinstance(index, int):
        idx, result = index & M32, 0
        for bit in range(32):
            if (idx >> bit) & 1:
                result ^= int(row[bit])
        return result
    idx = rngmod._u32(index)
    result = torch.zeros_like(idx)
    for bit in range(32):
        result = result ^ torch.where(((idx >> bit) & 1) != 0, int(row[bit]), 0)
    return result


def _to_unit(bits: Tensor) -> Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sobol_sample(index, dim: int, scramble: Tensor) -> Tensor:
    """Owen-scrambled Sobol' value in [0,1) for sample `index` (a Python
    int or a per-lane tensor), dimension `dim`, with per-lane scramble
    keys."""
    bits = _sobol_bits(index, _sobol_directions()[min(dim, SOBOL_DIMS - 1)])
    if isinstance(bits, int):
        bits = torch.full_like(rngmod._u32(scramble), bits)
    return _to_unit(owen_scramble(bits, scramble))


def _index(sample_idx):
    """A Python int stays one (host path); anything else is a tensor."""
    if isinstance(sample_idx, (int, np.integer)):
        return int(sample_idx)
    return torch.as_tensor(sample_idx)


def stratified_sample(pixel_id: Tensor, sample_idx, dim: int,
                      n_strata: int = 16) -> Tensor:
    """Jittered stratified value: stratum from a per-pixel permutation of the
    sample index, jitter + per-pixel rotation combined mod 1."""
    perm = rngmod.hash_combine(pixel_id, dim)
    stratum = (rngmod._u32(sample_idx) + perm) % n_strata
    st_j = rngmod.hash_combine(pixel_id, sample_idx, dim * 2 + 1)
    jitter = (st_j >> 8).to(torch.float32) / (1 << 24)
    rot = (perm >> 8).to(torch.float32) / (1 << 24)
    return torch.remainder((stratum.to(torch.float32) + jitter) / n_strata + rot, 1.0)


def sample_1d(sampler_type: int, pixel_id: Tensor, sample_idx, dim: int) -> Tensor:
    """Counter-based sample for dimension `dim` (a Python int); sample_idx
    is a Python int or a tensor broadcast against pixel_id."""
    sample_idx = _index(sample_idx)
    if not isinstance(sample_idx, int):
        sample_idx = torch.broadcast_to(sample_idx.to(pixel_id.device), pixel_id.shape)
    if sampler_type == STRATIFIED:
        return stratified_sample(pixel_id, sample_idx, dim)
    if sampler_type == SOBOL and dim < SOBOL_DIMS:
        return sobol_sample(sample_idx, dim, rngmod.hash_combine(pixel_id, dim))
    # sobol dims past the table: an independent draw (see sample_1d_dyn)
    _, u = rngmod.next_float(rngmod.seed(pixel_id, sample_idx, dim))
    return u


def sample_2d(sampler_type: int, pixel_id: Tensor, sample_idx, dim: int) -> Tensor:
    a = sample_1d(sampler_type, pixel_id, sample_idx, dim)
    b = sample_1d(sampler_type, pixel_id, sample_idx, dim + 1)
    return torch.stack([a, b], dim=-1)


def sample_1d_dyn(sampler_type: int, pixel_id: Tensor, sample_idx, dim: int) -> Tensor:
    """The JAX package's sample for a traced dimension index (4 + 6*depth in
    the bounce loop). The port's bounce loop is Python, so `dim` is a Python
    int and the row (or, past the 64-dimension table, the independent hash
    draw: reusing a row under another Owen seed does not decorrelate the
    pair) is chosen on the host; the value is sample_1d's, which equals the
    JAX function's for that dim bit for bit."""
    return sample_1d(sampler_type, pixel_id, sample_idx, int(dim))
