"""Image pipeline: reconstruction filters, tone mapping, NLM denoising.

Port of ``cudatracerlib_tpu/models/pipeline.py`` (the reference's
``Kernel/ImagePipeline/*``: filter -> post-process). Filters are separable
sums of shifted rows with edge padding, NLM a sum of shifted images over the
search window, all dense PyTorch ops, as they are dense jnp ops outside any
Pallas kernel in the JAX package. The Python sums keep the JAX order, so the
float sums round alike.

Reconstruction filter shapes mirror ``SceneTypes/Filter.h``: box, gaussian,
mitchell, lanczos-sinc, triangle (tent).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import spectrum
from . import blocksampler as bs
from . import film as filmmod

Tensor = torch.Tensor

F_BOX, F_GAUSSIAN, F_MITCHELL, F_LANCZOS, F_TRIANGLE = 0, 1, 2, 3, 4


def filter_kernel_1d(filter_type: int, radius: float = 2.0, taps: int = 5) -> np.ndarray:
    """Discrete 1D reconstruction kernel (normalized)."""
    x = np.linspace(-radius, radius, taps)
    if filter_type == F_BOX:
        w = (np.abs(x) <= 0.5).astype(np.float64)
        w = np.maximum(w, 1e-9) if w.sum() == 0 else w
    elif filter_type == F_GAUSSIAN:
        s = radius / 2.0
        w = np.exp(-0.5 * (x / s) ** 2) - np.exp(-0.5 * (radius / s) ** 2)
        w = np.maximum(w, 0)
    elif filter_type == F_MITCHELL:
        b = c = 1.0 / 3.0
        ax = np.abs(x)
        w = np.where(ax < 1,
                     ((12 - 9 * b - 6 * c) * ax ** 3 + (-18 + 12 * b + 6 * c) * ax ** 2
                      + (6 - 2 * b)) / 6,
                     np.where(ax < 2,
                              ((-b - 6 * c) * ax ** 3 + (6 * b + 30 * c) * ax ** 2
                               + (-12 * b - 48 * c) * ax + (8 * b + 24 * c)) / 6, 0.0))
    elif filter_type == F_LANCZOS:
        t = 3.0
        def sinc(v):
            safe = np.where(np.abs(v) < 1e-6, 1.0, v)
            return np.where(np.abs(v) < 1e-6, 1.0, np.sin(np.pi * safe) / (np.pi * safe))
        w = sinc(x) * sinc(x / t) * (np.abs(x) <= radius)
    else:  # triangle
        w = np.maximum(1.0 - np.abs(x) / radius, 0.0)
    return (w / w.sum()).astype(np.float32)


def _edge_rows(x: Tensor, pad: int, dim: int) -> Tensor:
    """x padded by `pad` along `dim` with its edge values (jnp.pad's
    mode="edge")."""
    n = x.shape[dim]
    idx = torch.arange(-pad, n + pad, device=x.device).clamp(0, n - 1)
    return x.index_select(dim, idx)


def apply_filter(img: Tensor, filter_type: int, radius: float = 2.0,
                 taps: int = 5) -> Tensor:
    """Separable reconstruction filter over an (H, W, 3) image."""
    if filter_type == F_BOX and taps <= 1:
        return img
    k = [float(v) for v in filter_kernel_1d(filter_type, radius, taps)]
    pad = taps // 2
    H, W = img.shape[:2]
    x = _edge_rows(img, pad, 0)
    rows = sum(k[i] * x[i:i + H] for i in range(taps))
    x = _edge_rows(rows, pad, 1)
    return sum(k[i] * x[:, i:i + W] for i in range(taps))


def tonemap_reinhard05(img: Tensor, key: float = 0.18, burn: float = 1.0) -> Tensor:
    """Reinhard photographic tonemapping over luminance (log-average
    luminance reduction + the curve with a white point)."""
    lum = spectrum.luminance(img)
    log_avg = torch.exp(torch.log(1e-4 + lum).mean())
    lw = lum.clamp_min(1e-8)
    l_scaled = key / log_avg.clamp_min(1e-8) * lw
    l_white2 = ((burn * l_scaled.max()) ** 2).clamp_min(1e-4)
    l_out = l_scaled * (1.0 + l_scaled / l_white2) / (1.0 + l_scaled)
    return img * (l_out / lw)[..., None]


def nlm_denoise(img: Tensor, variance: Tensor | None = None,
                search_radius: int = 5, patch_radius: int = 1,
                strength: float = 0.15) -> Tensor:
    """Non-local means with optional per-pixel variance modulation: for each
    offset of the search window, the patch distance is a box-filtered
    squared difference of the shifted image."""
    H, W, _ = img.shape
    if variance is None:
        variance = torch.full((H, W), 1e-4, dtype=torch.float32, device=img.device)
    h2 = max(strength * strength, 1e-6)
    psz = 2 * patch_radius + 1

    def box(x):
        p = patch_radius
        xp = _edge_rows(_edge_rows(x, p, 0), p, 1)
        acc = torch.zeros_like(x)
        for dy in range(psz):
            for dx in range(psz):
                acc = acc + xp[dy:dy + H, dx:dx + W]
        return acc / (psz * psz)

    acc = torch.zeros_like(img)
    wsum = torch.zeros((H, W), dtype=torch.float32, device=img.device)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            shifted = torch.roll(img, (dy, dx), dims=(0, 1))
            var_s = torch.roll(variance, (dy, dx), dims=(0, 1))
            d2 = ((img - shifted) ** 2).mean(-1)
            # variance-cancelled distance (Rousselle/Buades style)
            cancel = variance + torch.minimum(variance, var_s)
            dist = box((d2 - cancel) / (1e-6 + h2 * (variance + var_s)))
            wgt = torch.exp(-dist.clamp_min(0.0))
            acc = acc + shifted * wgt[..., None]
            wsum = wsum + wgt
    return acc / wsum.clamp_min(1e-9)[..., None]


def apply_pipeline(film: filmmod.Film, filter_type: int = F_BOX,
                   tonemap: bool = False, denoise: bool = False,
                   vb: "bs.VarianceBuffer | None" = None,
                   splat_scale=None) -> Tensor:
    """filter -> (NLM) -> (tonemap): returns linear HDR RGB ready for sRGB.
    Sample-side filtering already happens by filter importance sampling,
    so `filter_type` here is the display-time reconstruction pass."""
    img = filmmod.develop(film, splat_scale)
    if filter_type != F_BOX:
        img = apply_filter(img, filter_type)
    if denoise:
        var = bs.pixel_variance(vb) if vb is not None else None
        img = nlm_denoise(img, var)
    if tonemap:
        img = tonemap_reinhard05(img)
    return img
