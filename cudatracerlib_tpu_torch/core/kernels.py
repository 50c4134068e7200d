"""Density-estimation smoothing kernels (reference: ``Math/Kernel.h:40-110``).

Port of ``cudatracerlib_tpu/core/kernels.py``. k(t, r) gives the kernel
weight for a point at distance t from the query center with support radius
r, normalized so the kernel integrates to 1 over the `dim`-dimensional ball
of radius r. The boundary-correction tables are computed with numpy at
import, by the same code as the JAX package's.
"""
from __future__ import annotations

import math

import numpy as _np
import torch

UNIFORM, PERLIN = 0, 1

# Volume of the unit ball per dimension
_BALL_VOL = {1: 2.0, 2: math.pi, 3: 4.0 * math.pi / 3.0}
# Integral of the Perlin smootherstep profile w(t)=1-(6t^5-15t^4+10t^3) over the
# unit ball: dim1 = 2*1/2, dim2 = 2*pi*1/7, dim3 = 4*pi*5/84
_PERLIN_NORM = {1: 1.0, 2: 2.0 * math.pi / 7.0, 3: 5.0 * math.pi / 21.0}


def _perlin_profile(t):
    t = t.clamp(0.0, 1.0)
    return 1.0 - (t * t * t * (t * (t * 6.0 - 15.0) + 10.0))


def k(kernel_type, t, r, dim: int = 3):
    """Kernel weight for distance t, radius r, normalized in `dim` dimensions."""
    r = torch.as_tensor(r, dtype=torch.float32, device=t.device).clamp_min(1e-12)
    x = (t / r).clamp(0.0, 1.0)
    rd = r ** dim
    w_uniform = torch.where(x <= 1.0, 1.0, 0.0) / (_BALL_VOL[dim] * rd)
    w_perlin = _perlin_profile(x) / (_PERLIN_NORM[dim] * rd)
    if not torch.is_tensor(kernel_type):
        return w_perlin if kernel_type == PERLIN else w_uniform
    return torch.where(kernel_type == PERLIN, w_perlin, w_uniform)


def uniform_k(t, r, dim: int = 3):
    return k(UNIFORM, t, r, dim)


def perlin_k(t, r, dim: int = 3):
    return k(PERLIN, t, r, dim)


# ---------------------------------------------------------------------------
# Boundary correction for density estimation near medium boundaries
# ---------------------------------------------------------------------------
# A kernel whose support crosses the medium boundary collects no photons from
# the outside part, biasing the estimate dark near boundaries. The correction
# renormalizes by the kernel-mass fraction inside the half-space at signed
# distance b from the center: contribution /= frac(b / r). The tables hold
# the Perlin profile's fractions, by quadrature.


def _mass_inside_tables(n: int = 33):
    qs = _np.linspace(0.0, 1.0, n)
    xs = _np.linspace(-1.0, 1.0, 801)
    dx = xs[1] - xs[0]

    def prof(t):
        t = _np.clip(t, 0.0, 1.0)
        return 1.0 - (t * t * t * (t * (t * 6.0 - 15.0) + 10.0))

    out = {}
    for dim in (1, 2, 3):
        # kernel mass with support x >= -q (x measured along the boundary
        # normal), as a fraction of the full mass
        if dim == 1:
            w_x = prof(_np.abs(xs))
        else:
            # integrate the (dim-1)-dimensional slice at each x
            w_x = _np.zeros_like(xs)
            ys = _np.linspace(-1.0, 1.0, 401)
            dy = ys[1] - ys[0]
            for i, x in enumerate(xs):
                rr = _np.sqrt(x * x + ys * ys)
                pw = _np.where(rr <= 1.0, prof(rr), 0.0)
                if dim == 2:
                    w_x[i] = pw.sum() * dy
                else:  # 3D: slice is a disc -> radial weight 2*pi*|y|
                    w_x[i] = (pw * 2.0 * _np.pi * _np.abs(ys)).sum() * dy
        total = w_x.sum() * dx
        fr = _np.array([w_x[xs >= -q].sum() * dx / total for q in qs])
        out[dim] = _np.clip(fr, 0.05, 1.0).astype(_np.float32)
    return out[1], out[2], out[3]


_FRAC_1D, _FRAC_2D, _FRAC_3D = _mass_inside_tables()
_FRAC_NP = {1: _FRAC_1D, 2: _FRAC_2D, 3: _FRAC_3D}
_FRAC = {}   # (dim, device) -> the table there, copied once


def _frac_table(dim: int, device) -> torch.Tensor:
    key = (dim, str(device))
    if key not in _FRAC:
        _FRAC[key] = torch.from_numpy(_FRAC_NP[dim]).to(device)
    return _FRAC[key]


def boundary_frac(b, r, dim: int):
    """Fraction of the (Perlin) kernel mass inside the medium when the kernel
    center sits at distance b >= 0 from the nearest boundary (dim = kernel
    dimensionality: 1 beam-beam, 2 beam-disc, 3 point gathers)."""
    tab = _frac_table(dim, b.device)
    r = torch.as_tensor(r, dtype=torch.float32, device=b.device)
    q = (b / r.clamp_min(1e-12)).clamp(0.0, 1.0) * (tab.shape[0] - 1)
    q0 = torch.floor(q).to(torch.int32).clamp(0, tab.shape[0] - 2)
    f = q - q0
    q0 = q0.long()
    return tab[q0] * (1.0 - f) + tab[q0 + 1] * f
