"""Rough dielectric transmittance tables.

Port of ``cudatracerlib_tpu/core/rough_transmittance.py``: the tables are
computed on first use (a vectorised numpy Monte Carlo of the microfacet
reflectance integral, seeded per distribution, bit-identical to the JAX
package's) and kept in this process only: nothing is written to disk.
Rough plastic and the rough coating weight their diffuse energy with them:
E(cos_i, alpha) is the directional-hemispherical specular reflectance.
"""
from __future__ import annotations

import numpy as np
import torch

_CACHE: dict = {}      # (dist, eta rounded to 3 places) -> (32, 32) float32
_DEVICE_CACHE: dict = {}   # (dist, device) -> (the eta knots' tables, the knots)
_N_COS, _N_ALPHA, _N_MC = 32, 32, 2048
_ALPHA_MAX = 1.0


def _compute_table(dist: int, eta: float) -> np.ndarray:
    """E_spec(cos_i, alpha) for a rough dielectric with relative IOR eta."""
    rng = np.random.default_rng(1234 + dist)
    cos_i = np.linspace(0.02, 1.0, _N_COS)
    alphas = np.linspace(0.01, _ALPHA_MAX, _N_ALPHA)
    u1 = rng.random(_N_MC)
    u2 = rng.random(_N_MC)
    table = np.zeros((_N_COS, _N_ALPHA), np.float32)
    for ai, alpha in enumerate(alphas):
        # sample micronormals ~ D(m) cos m
        if dist == 1:  # ggx
            t2 = alpha * alpha * u1 / np.maximum(1 - u1, 1e-9)
        else:          # beckmann / phong-equivalent
            t2 = -alpha * alpha * np.log(np.maximum(1 - u1, 1e-9))
        ct = 1.0 / np.sqrt(1 + t2)
        st = np.sqrt(np.maximum(1 - ct * ct, 0))
        phi = 2 * np.pi * u2
        m = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)  # (M,3)
        for ci, c in enumerate(cos_i):
            wi = np.array([np.sqrt(max(1 - c * c, 0.0)), 0.0, c])
            dot = np.abs(m @ wi)
            # fresnel at the micronormal
            s2 = np.maximum(1 - dot * dot, 0) / (eta * eta)
            tir = s2 >= 1.0
            ctt = np.sqrt(np.maximum(1 - s2, 0))
            rs = (dot - eta * ctt) / np.maximum(dot + eta * ctt, 1e-9)
            rp = (eta * dot - ctt) / np.maximum(eta * dot + ctt, 1e-9)
            F = np.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
            # the mirror direction of wi about m must leave the surface
            wo_z = 2 * dot * m[:, 2] - wi[2]
            valid = wo_z > 0
            table[ci, ai] = float(np.mean(F * valid))
    return np.clip(table, 0.0, 1.0)


def get_table(dist: int, eta: float = 1.5) -> np.ndarray:
    """(32, 32) E_spec table over (cos_i in [0,1], alpha in [0,1]), computed
    once per process for each (dist, eta to 3 places)."""
    key = (dist, round(float(eta), 3))
    if key not in _CACHE:
        _CACHE[key] = _compute_table(dist, eta)
    return _CACHE[key]


def _cell(cos_i, alpha):
    """The bilinear cell of (cos_i, alpha): corner indices and weights."""
    x = cos_i.abs().clamp(0.0, 1.0) * (_N_COS - 1)
    y = (alpha / _ALPHA_MAX).clamp(0.0, 1.0) * (_N_ALPHA - 1)
    x0 = torch.floor(x).to(torch.int32).clamp(0, _N_COS - 2)
    y0 = torch.floor(y).to(torch.int32).clamp(0, _N_ALPHA - 2)
    return x0.long(), y0.long(), x - x0, y - y0


def _bilerp(g, fx, fy):
    """Bilinear blend of g(dx, dy), the table at the cell's corners."""
    return (g(0, 0) * (1 - fx) * (1 - fy) + g(1, 0) * fx * (1 - fy)
            + g(0, 1) * (1 - fx) * fy + g(1, 1) * fx * fy)


def eval_specular_albedo(dist: int, eta: float, cos_i, alpha):
    """Interpolated E_spec of one table for batched tensors (bilinear)."""
    t = torch.from_numpy(get_table(dist, eta)).to(cos_i.device)
    x0, y0, fx, fy = _cell(cos_i, alpha)
    return _bilerp(lambda dx, dy: t[x0 + dx, y0 + dy], fx, fy)


# eta knots for the per-lane-IOR interpolation
_ETA_KNOTS = (1.1, 1.3, 1.5, 1.7, 2.0)


def _knot_tables(dist: int, device):
    """(the knots' stacked tables, the knots) on `device`, copied there once
    (a copy from host memory waits for the device's queue to drain)."""
    key = (dist, str(device))
    if key not in _DEVICE_CACHE:
        _DEVICE_CACHE[key] = (
            torch.from_numpy(np.stack([get_table(dist, e) for e in _ETA_KNOTS])).to(device),
            torch.tensor(_ETA_KNOTS, dtype=torch.float32, device=device))
    return _DEVICE_CACHE[key]


def eval_specular_albedo_eta(dist: int, eta, cos_i, alpha):
    """E_spec with per-lane eta: trilinear over (eta, cos_i, alpha).

    eta/cos_i/alpha are (B,) tensors; eta is clamped to the knot range."""
    return eval_specular_albedo_dists((dist,), eta, cos_i, alpha)[0]


def eval_specular_albedo_dists(dists, eta, cos_i, alpha):
    """eval_specular_albedo_eta for each distribution of `dists` on the
    same lanes, sharing the cell and eta weights: each result equals its
    own eval_specular_albedo_eta bit for bit, with fewer launches."""
    e = eta.clamp(_ETA_KNOTS[0], _ETA_KNOTS[-1])
    knots = _knot_tables(dists[0], cos_i.device)[1]
    hi = torch.searchsorted(knots, e.contiguous(), right=True).clamp(
        1, len(_ETA_KNOTS) - 1)
    lo = hi - 1
    we = (e - knots[lo]) / (knots[hi] - knots[lo]).clamp_min(1e-6)
    x0, y0, fx, fy = _cell(cos_i, alpha)
    out = []
    for dist in dists:
        tabs = _knot_tables(dist, cos_i.device)[0]

        def at(ei):
            return _bilerp(lambda dx, dy: tabs[ei, x0 + dx, y0 + dy], fx, fy)
        out.append(at(lo) * (1.0 - we) + at(hi) * we)
    return out
