"""Numerical quadrature (reference: ``Math/Integrator.h``: Gauss-Lobatto and
Gauss-Legendre, used for heterogeneous-volume optical depth).

Port of ``cudatracerlib_tpu/core/quadrature.py``. Nodes and weights are
float32, as the JAX package's are.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# 7-point Gauss-Lobatto nodes/weights on [-1, 1] (weights sum to 2)
_GL7_X = np.array([-1.0, -0.830223896278567, -0.468848793470714, 0.0,
                   0.468848793470714, 0.830223896278567, 1.0])
_GL7_W = np.array([2.0 / 42, 0.276826047361566, 0.431745381209863,
                   0.487619047619048, 0.431745381209863, 0.276826047361566,
                   2.0 / 42])


def gauss_legendre(n: int):
    """(nodes, weights) on [-1, 1], float32 on the CPU."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(w.astype(np.float32)))


def _span(a, b):
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    return 0.5 * (b - a), 0.5 * (a + b)


def integrate(f, a, b, n: int = 16) -> Tensor:
    """Fixed-order Gauss-Legendre integral of a batched integrand f(t)."""
    x, w = gauss_legendre(n)
    half, mid = _span(a, b)
    x, w = x.to(half.device), w.to(half.device)
    total = 0.0
    for i in range(n):
        total = total + w[i] * f(mid + half * x[i])
    return total * half


def integrate_lobatto7(f, a, b) -> Tensor:
    """7-point Gauss-Lobatto (includes the endpoints, like the reference's
    adaptive Lobatto base rule)."""
    half, mid = _span(a, b)
    total = 0.0
    for xi, wi in zip(_GL7_X.astype(np.float32), _GL7_W.astype(np.float32)):
        total = total + float(wi) * f(mid + half * float(xi))
    return total * half
