"""Cubic Catmull-Rom spline evaluation (reference: ``Math/Spline.h``, used by
the rough-transmittance 2D interpolation and function models).

Port of ``cudatracerlib_tpu/core/spline.py``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def catmull_rom_weights(t: Tensor):
    """Weights for p_{-1}, p_0, p_1, p_2 at parameter t in [0,1]."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _cell(x: Tensor, n: int):
    """(cell index i in [0, n-2], fraction t) of x in [0,1] over n samples."""
    fx = x.clamp(0.0, 1.0) * (n - 1)
    i = torch.floor(fx).to(torch.int32).clamp(0, n - 2)
    return i, fx - i


def eval_1d(values: Tensor, x: Tensor) -> Tensor:
    """Catmull-Rom interpolate a uniformly-sampled 1D table at x in [0,1]."""
    n = values.shape[0]
    i, t = _cell(x, n)
    g = lambda k: values[(i + k).clamp(0, n - 1).long()]
    w0, w1, w2, w3 = catmull_rom_weights(t)
    return w0 * g(-1) + w1 * g(0) + w2 * g(1) + w3 * g(2)


def eval_2d(table: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Separable bicubic Catmull-Rom over a (H, W) table, x/y in [0,1]
    (the reference's RoughTransmittance::Evaluate interpolation)."""
    h, w = table.shape
    j, ty = _cell(y, h)
    wy = catmull_rom_weights(ty)
    i, tx = _cell(x, w)
    wx = catmull_rom_weights(tx)
    rows = 0.0
    for k in range(-1, 3):
        row = table[(j + k).clamp(0, h - 1).long()]
        val = 0.0
        for m in range(-1, 3):
            idx = (i + m).clamp(0, w - 1).long()
            col = (torch.gather(row, -1, idx[..., None])[..., 0] if row.ndim > 1
                   else row[idx])
            val = val + wx[m + 1] * col
        rows = rows + wy[k + 1] * val
    return rows
